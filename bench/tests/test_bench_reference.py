"""The plain reference against the port at small widths (both routes,
fp32 and int8), the benchmark's weights, and the controls: the
reference one precision step down must fail the comparison."""
import json

import numpy as np
import pytest
import torch

from bench import correctness, generator, weights
from bench.families import delta_lstm as family
from bench.reference import delta_lstm as ref
from bench.program import import_port
from bench.tests.conftest import ROOT

import_port()


def config(hidden, layers, route, quant, m=64):
    cfg = json.loads((ROOT / "bench/configs/dlstm-2l1024h.json").read_text())
    cfg.update(hidden_dim=hidden, fc_dim=hidden, n_layers=layers,
               spmv_path=route, quant=quant, m=m,
               precision="int8" if quant else "fp32")
    return cfg


MIXES = ["bulk", "noise-bulk"]


def feats_for(seed, n=6, mix="bulk"):
    t = json.loads((ROOT / f"bench/traffic/{mix}.json").read_text())
    t["lengths"] = {"median": 40, "sigma": 0.4, "min": 20, "max": 70}
    return generator.make_plan(dict(t, utterances=n), 123, seed, 1.0).feats


def port_logits(params, cfg, feats, device="cpu"):
    from repro_torch import serving as rt

    from bench import program

    engine = program.pool_engine(params, cfg, family, torch.device(device))
    reqs = [rt.StreamRequest(i, 0, f) for i, f in enumerate(feats)]
    results, _ = rt.serve_requests(engine, reqs, 4, chunk_frames=8)
    return [r.logits for r in results]


# (hidden, layers, route, quant, M, frames): "auto" takes the dense
# mirror where S (1 - gamma) >= 1, so M = 16 at these widths.  The mirror
# sums every product exactly and rounds once, as the reference does, and
# so does the scatter kernel on the int8 / Q8.8 grids (each product and
# sum is exact in fp32): whole utterances agree.  fp32 deltas on the
# scatter route are summed in float32 in list order; the recurrence
# carries a last-bit difference through the delta thresholds without
# bound, so that route is compared over its first frames only.
CASES = [(64, 2, "auto", False, 16, None),
         (128, 2, "scatter", False, 64, 3),
         (64, 3, "scatter", True, 64, None),
         (128, 2, "auto", True, 16, None)]


def gap_over(got, want, frames):
    if frames is not None:
        got = [g[:frames] for g in got]
        want = [w[:frames] for w in want]
    return correctness.logit_gap(got, want)


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("hidden,layers,route,quant,m,frames", CASES)
def test_reference_matches_the_port(hidden, layers, route, quant, m,
                                    frames, mix):
    cfg = config(hidden, layers, route, quant, m)
    params = family.make_params(cfg, 7, torch.device("cpu"))
    feats = feats_for(7, mix=mix)
    got = port_logits(params, cfg, feats)
    want = correctness.reference_logits(ref, params, cfg, feats, "cpu")
    assert max(float(np.abs(w).std()) for w in want) > 1e-3   # not silent
    assert gap_over(got, want, frames) <= 1e-6


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("hidden,layers,route,quant,m,frames", CASES)
def test_controls_fail(hidden, layers, route, quant, m, frames, mix):
    """The control, the reference in the program's place a precision
    step below the configuration's (TF32 for fp32, int4 for int8),
    reads far above the limit."""
    cfg = config(hidden, layers, route, quant, m)
    control = "int4" if quant else "tf32"
    for seed in (1, 2, 3):
        params = family.make_params(cfg, seed, torch.device("cpu"))
        feats = feats_for(seed, mix=mix)
        want = correctness.reference_logits(ref, params, cfg, feats, "cpu")
        got = correctness.reference_logits(ref, params, cfg, feats, "cpu",
                                           control)
        assert correctness.logit_gap(got, want) > 10 * cfg["limits"][
            "logit_gap"]


def test_cbtd_keeps_a_balanced_count():
    cfg = config(64, 2, "auto", False)
    params = family.make_params(cfg, 3, torch.device("cpu"))
    for lp in params["lstm"]:
        w = torch.cat([lp["w_x"], lp["w_h"]], dim=1)
        s = w.shape[0] // cfg["m"]
        per_sub = (w != 0).reshape(s, cfg["m"], -1).sum(0)
        assert (per_sub == s - int(s * cfg["gamma"])).all()
    # the kept weights carry the 1/(1-gamma) gain
    assert float(params["lstm"][0]["w_x"].abs().max()) > 1.0 / 8


def test_benchmark_prune_is_cbtd():
    from repro_torch.core import apply_cbtd

    w = torch.randn(256, 40, generator=torch.Generator().manual_seed(0))
    kept = w * weights.cbtd_keep_mask(w, 0.9375, 64)
    assert torch.equal(kept, apply_cbtd(w, gamma=0.9375, m=64))


def test_tf32_rounding():
    from bench.reference.delta_lstm import round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159,
                      1e-30, 0.0])
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0            # tie to even
    assert y[2] == 1.0 + 2 ** -9                  # tie to even, up
    bits = y.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()
    assert abs(float(y[3]) + 3.14159) < 3.14159 * 2 ** -11


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,layers,route,quant,m,frames", CASES)
def test_reference_matches_the_port_on_the_card(cuda, hidden, layers, route,
                                                quant, m, frames):
    cfg = config(hidden, layers, route, quant, m)
    params = family.make_params(cfg, 11, cuda)
    feats = feats_for(11)
    got = port_logits(params, cfg, feats, "cuda")
    want = correctness.reference_logits(ref, params, cfg, feats, cuda)
    # the head's cuBLAS GEMMs round in another order than the host's
    assert gap_over(got, want, frames) <= 1e-5
