"""One tree's layer-step costs on one NVIDIA GPU, for comparing two trees.

    python tools/step_ab.py [--src DIR] [--label NAME] [--seed N]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``; give
the ``src`` of another commit unpacked with ``git archive`` to measure
that commit; its kernels build under its own ``build/``) and measures, at
the paper's 2x1024 DeltaLSTM shapes (B=16, layer 2: D=H=1024):

* host time per call of the kernel wrappers the engines call
  (``ops.delta_encode_batch``, ``ops.lstm_pointwise_batch``,
  ``ops.stsp_spmv_batch``, and the fused ``ops.delta_encode_step`` /
  ``ops.lstm_pointwise_step`` where the tree has them): back-to-back
  calls, which the host sets, the least of 7 runs of 200 calls (the
  host's clock is noisy on a shared machine);
* the IPU and HPE stages of one layer-step as the tree's
  ``BatchedSpartusEngine._step_core`` runs them, 12 of 16 slots active:
  host time per call as above, and device time (every device event of
  the stage);
* ``chip_smoke.profile_serving`` of this checkout on the tree: one wave
  per route, launches per layer-frame, device busy time, idle share.

Prints one JSON line.  To compare two trees, run it in turns in one call
(parent, change, change, parent).  It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def stages(torch, ops, layer, active):
    """The IPU and HPE stages of one layer-step at B=16 as the tree's
    engine runs them: fused calls where the tree has them, else the
    PyTorch glue around the unfused kernels."""
    g = torch.Generator(device="cuda").manual_seed(1)
    b, d, h = 16, layer.input_dim, layer.hidden_dim
    x = torch.randn((b, d), generator=g, device="cuda")
    hid = torch.randn((b, h), generator=g, device="cuda")
    s_hat = torch.cat([x, hid], -1) + 0.3 * torch.randn(
        (b, d + h), generator=g, device="cuda")
    dm = 2 * torch.randn((b, 4 * h), generator=g, device="cuda")
    y = 0.01 * torch.randn((b, 4 * h), generator=g, device="cuda")
    c = torch.randn((b, h), generator=g, device="cuda")
    am = active[:, None]
    if hasattr(ops, "delta_encode_step"):
        def ipu():
            ops.delta_encode_step(x, hid, s_hat, 0.3, active=active)

        def hpe():
            ops.lstm_pointwise_step(dm, y, c, hid, active=active)
    else:
        def ipu():
            s = torch.cat([x, hid], dim=-1)
            _, new, _ = ops.delta_encode_batch(s, s_hat, 0.3)
            s_hat.copy_(torch.where(am, new, s_hat))

        def hpe():
            dm_new = dm + y
            h_new, c_new = ops.lstm_pointwise_batch(dm_new.view(b, 4, h), c)
            c.copy_(torch.where(am, c_new, c))
            hid.copy_(torch.where(am, h_new, hid))
            dm.copy_(torch.where(am, dm_new, dm))
    return {"ipu": ipu, "hpe": hpe}


def wrappers(torch, ops, layer):
    g = torch.Generator(device="cuda").manual_seed(2)
    s = torch.randn((16, 2048), generator=g, device="cuda")
    s_hat = s + 0.3 * torch.randn((16, 2048), generator=g, device="cuda")
    dm = torch.randn((16, 4, 1024), generator=g, device="cuda")
    c = torch.randn((16, 1024), generator=g, device="cuda")
    fired = torch.rand((16, 2048), generator=g, device="cuda") < 0.3
    delta = torch.where(fired, s, 0.0)
    idx, vals, _ = ops.select_active_columns_batch(delta, layer.capacity)
    enc = layer.enc
    calls = {
        "delta_encode_batch": lambda: ops.delta_encode_batch(s, s_hat, 0.3),
        "lstm_pointwise_batch": lambda: ops.lstm_pointwise_batch(dm, c),
        "stsp_spmv_batch": lambda: ops.stsp_spmv_batch(
            enc.val, enc.lidx, idx, vals, s=enc.s),
    }
    if hasattr(ops, "delta_encode_step"):
        x, hid = s[:, :1024].contiguous(), s[:, 1024:].contiguous()
        dm2, y = dm.view(16, -1).clone(), 0.01 * dm.view(16, -1)
        hid2 = hid.clone()
        calls["delta_encode_step"] = lambda: ops.delta_encode_step(
            x, hid, s_hat, 0.3)
        calls["lstm_pointwise_step"] = lambda: ops.lstm_pointwise_step(
            dm2, y, c, hid2)
    return calls


def host_ms(torch, fn, calls: int = 200, runs: int = 7) -> float:
    """Host time per call of back-to-back calls: the least of ``runs``
    runs, each ending in a device sync."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("step_ab: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch import serving as rt
    from repro_torch.configs.spartus_lstm import DELTA_LSTM_2L_1024H
    from repro_torch.kernels import ops
    from repro_torch.models import lstm_am

    am_cfg = DELTA_LSTM_2L_1024H
    params = cs.servable_params(lstm_am, am_cfg, args.seed)
    layer = rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
        theta=am_cfg.theta, gamma=cs.GAMMA, m=cs.M,
        spmv_path="scatter")).layers[1]
    active = torch.arange(16, device="cuda") % 4 != 3
    result = {"label": args.label, "src": args.src,
              "device": cs.nvidia_smi(), "wrapper_ms": {}, "stage_ms": {},
              "stage_device_ms": {}}
    for name, fn in wrappers(torch, ops, layer).items():
        result["wrapper_ms"][name] = host_ms(torch, fn)
    for name, fn in stages(torch, ops, layer, active).items():
        result["stage_ms"][name] = host_ms(torch, fn)
        result["stage_device_ms"][name] = cs.device_ms(torch, fn, "")
    requests = cs.make_requests(rt, am_cfg,
                                np.random.default_rng(args.seed))
    result["profile"] = [
        {k: v for k, v in entry.items() if k != "by_kernel"}
        for entry in cs.profile_serving(torch, params, am_cfg, requests,
                                        None)]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
