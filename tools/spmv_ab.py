"""A/B device time of CBCSC SpMV kernel sources on one NVIDIA GPU.

    python tools/spmv_ab.py SOURCE[:NVCC_FLAG...] [SOURCE[:FLAG...] ...]

Each SOURCE is a copy of ``src/repro_torch/kernels/csrc/spartus_kernels.cu``
(a variant of the SpMV kernel); ``:``-separated flags after it are passed
to nvcc (``-DNAME`` switches in a variant).  Every source is built into
``build/spmv_ab/`` with the port's nvcc flags, then each one's
``spartus_stsp_spmv_{f32_i32,i8_i8}`` is timed at the 2x1024 model's
layer shapes (Q=2048 and 1147, M=64, BLEN=4, K=Q/2, ~30% of the columns
fired, B=16 and B=1) in the order A, B, ..., B, A, as the mean device
time of 50 launches from torch.profiler.  A source given without flags
must equal the plain scatter on the host bit for bit.  Prints one line
per source and case with the two times in ms.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "spmv_ab"


def build(spec: str, tag: str):
    from repro_torch.kernels import _build

    src, *flags = spec.split(":")
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib_{tag}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                           str(lib), src], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed on {spec}:\n{proc.stderr[-3000:]}")
    handle = ctypes.CDLL(str(lib))
    for name in ("spartus_stsp_spmv_f32_i32", "spartus_stsp_spmv_i8_i8"):
        getattr(handle, name).argtypes = _build.SIGNATURES[name]
        getattr(handle, name).restype = ctypes.c_int
    return handle


def device_ms(torch, fn, iters: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "stsp_spmv" in e.key) / iters / 1e3


def cases(torch):
    from repro_torch.core import apply_cbtd, blen_for, cbcsc_encode
    from repro_torch.kernels import ops
    from repro_torch.kernels import stsp_spmv as sp

    gen = torch.Generator().manual_seed(0)
    out = []
    for q in (2048, 1147):
        w = apply_cbtd(torch.randn((4096, q), generator=gen) * 0.1, 0.9375,
                       64)
        enc = cbcsc_encode(w, 64, blen=blen_for(4096, 64, 0.9375))
        fired = torch.rand((16, q), generator=gen) < 0.3
        delta = torch.where(fired, torch.randn((16, q), generator=gen), 0.0)
        idx, ds, _ = ops.select_active_columns_batch(delta, q // 2)
        val8 = torch.round(enc.val / 2 ** -7).clamp(-127, 127).to(torch.int8)
        for label, v, l in (("f32", enc.val, enc.lidx),
                            ("i8", val8, enc.lidx.to(torch.int8))):
            for b in (16, 1):
                host = sp.plain_batch(v, l, idx[:b], ds[:b], enc.s)
                out.append((f"Q={q} B={b} {label}", label, v.cuda(),
                            l.cuda(), idx[:b].contiguous().cuda(),
                            ds[:b].contiguous().cuda(), enc.s, host))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("spmv_ab: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    libs = [(spec, build(spec, f"v{i}"))
            for i, spec in enumerate(args.sources)]
    inputs = cases(torch)
    runs = list(range(len(libs))) + list(reversed(range(len(libs))))
    times = {}
    for i in runs:
        spec, lib = libs[i]
        for name, label, v, l, ii, dd, s, host in inputs:
            lidx_tag = "i32" if label == "f32" else "i8"
            fn = getattr(lib, f"spartus_stsp_spmv_{label}_{lidx_tag}")
            b, k = ii.shape
            q, m, blen = v.shape
            y = torch.empty((b, s * m), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            call = lambda: fn(  # noqa: E731
                0, v.data_ptr(), l.data_ptr(), ii.data_ptr(), dd.data_ptr(),
                y.data_ptr(), b, k, q, m, blen, s, stream)
            if call() != 0:
                sys.exit(f"{spec} {name}: launch failed")
            torch.cuda.synchronize()
            if ":" not in spec and not torch.equal(y.cpu(), host):
                sys.exit(f"{spec} {name}: differs from the host scatter")
            times.setdefault((spec, name), []).append(device_ms(torch, call))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for (spec, name), t in times.items():
        print(f"{spec:40s} {name:16s} " + " ".join(f"{x:.4f}" for x in t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
