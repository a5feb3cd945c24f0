"""Port parity of the zoo's train step (``repro_torch.launch.steps.
make_train_step``) on the CPU: one architecture per family (dense, moe,
vlm, ssm, hybrid, audio) at ``.reduced()``, the reference's params and a
seeded numpy batch on both sides, remat on, with 1 and 2 microbatches.

- the loss and the gradient norm within the zoo's parity gate (1e-5 of
  |reference| + 1e-6, ``torch_zoo_parity.REL``/``ABS``);
- the clipped gradients, read from AdamW's first moment (``m = (1 - b1)
  g`` after one step), leaf for leaf within 1e-4 of the leaf's largest
  reference gradient (``torch_zoo_parity.GRAD_REL``); ``v`` likewise;
- the parameters after the update, within a bound derived from that
  gate.  Adam's first step moves an element by ``lr * g / (|g| + eps)``,
  about ``lr * sign(g)``: where the reference's gradient ``g`` is within
  the gate ``d`` of 0 the two signs may differ and the element may move
  up to ``2 lr`` apart; elsewhere the two moves differ by at most ``lr *
  eps * d / (|g| - d)**2``, plus float32 rounding (``2**-23 |p|`` and
  ``lr * 2**-21``).  The share of elements of the first kind is bounded
  too, so the comparison is not vacuous;
- the leaves without gradient the same on both sides, and named
  (``ZERO_GRAD_LEAVES``: the vlm family's embedding);
- ``pick_q_chunk``/``pick_microbatches`` over every (arch, ``SHAPES``
  cell), ``quantize_params_abstract``/``dequantize_params`` on the same
  int8 arrays, ``make_serve_step``/``make_prefill_step`` against ``api``,
  and the microbatch sum against one made by hand;
- the SSD's gradient finite where the reference's overflows to NaN (the
  reference masks the intra-chunk decay after its exp; the port before).

The ssm, hybrid and audio families are in
``tests/test_torch_train_steps_recurrent.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro_torch import _tree
from repro_torch import perf as tperf
from repro_torch.configs import REGISTRY
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models.config import SHAPES
from torch_zoo_parity import (ARCHS, SEQ, ref_params, t, train_batch,
                              train_step_parity)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_train_step_matches_reference(family, microbatches):
    train_step_parity(family, microbatches)


@pytest.mark.parametrize("name", ARCHS)
def test_step_heuristics_match_reference(name, monkeypatch):
    """``pick_q_chunk`` and ``pick_microbatches`` over every ``SHAPES``
    cell, and ``REPRO_MICROBATCHES`` overriding the latter."""
    jcfg, tcfg = JREGISTRY[name], REGISTRY[name]
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    for jcell, tcell in zip(JSHAPES, SHAPES):
        assert (tsteps.pick_q_chunk(tcell.seq_len)
                == jsteps.pick_q_chunk(jcell.seq_len))
        assert (tsteps.pick_microbatches(tcfg, tcell)
                == jsteps.pick_microbatches(jcfg, jcell))
    monkeypatch.setenv("REPRO_MICROBATCHES", "3")
    assert tsteps.pick_microbatches(tcfg, SHAPES[0]) == 3 == (
        jsteps.pick_microbatches(jcfg, JSHAPES[0]))


def test_quantized_serving_tree_matches_reference():
    """``quantize_params_abstract``'s shapes and dtypes, and
    ``dequantize_params`` on the same int8 arrays and scales (bf16, and
    fp32), equal to the reference's."""
    name = "qwen2-0.5b"
    jabs = jsteps.quantize_params_abstract(
        jsteps.abstract_params(JREGISTRY[name].reduced()))
    tabs = tsteps.quantize_params_abstract(
        tsteps.abstract_params(REGISTRY[name].reduced()))
    want = {p: (tuple(l.shape), str(l.dtype)) for p, l in
            _tree.leaves_with_path(jax.tree.map(
                lambda l: np.empty(l.shape, l.dtype), jabs))}
    got = {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in _tree.leaves_with_path(tabs)}
    assert got == want
    rng = np.random.default_rng(0)
    params = ref_params(name)
    q = jax.tree.map(lambda a: (rng.integers(-127, 128, a.shape)
                                .astype(np.int8) if a.ndim >= 2 else a),
                     params)
    scales = jax.tree.map(lambda a: (np.float32(rng.uniform(1e-3, 1e-1))
                                     if a.ndim >= 2
                                     else np.zeros((0,), np.float32)), params)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = _tree.leaves_with_path(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)),
            jsteps.dequantize_params(
                {"q": jax.tree.map(jnp.asarray, q),
                 "scales": jax.tree.map(jnp.asarray, scales)}, jdt)))
        got = tsteps.dequantize_params(
            {"q": _tree.tree_map(t, q), "scales": _tree.tree_map(t, scales)},
            tdt)
        for (path, w), g in zip(want, _tree.leaves(got)):
            assert g.dtype == (tdt if w.ndim >= 2 else torch.float32), path
            assert np.array_equal(g.float().numpy(), w), path


def test_serve_and_prefill_steps_are_the_api():
    """``make_serve_step`` (plain and under ``int8_weights``) and
    ``make_prefill_step`` compute what ``api`` computes, bit for bit."""
    cfg = REGISTRY["qwen2-0.5b"].reduced()
    params = tapi.params_from_numpy(ref_params("qwen2-0.5b"), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = tsteps.make_prefill_step(cfg, 8)(params, toks)
        assert torch.equal(got, tapi.prefill(params, cfg, toks))
        cache = tapi.init_cache(cfg, 2, 16, device="cpu")
        got, c1 = tsteps.make_serve_step(cfg)(params, cache, toks[:, :1])
        want, c2 = tapi.serve_step(params, cfg, toks[:, :1], cache)
        assert torch.equal(got, want) and int(c1["pos"]) == int(c2["pos"])
        pq = {"q": _tree.tree_map(
                  lambda a: (a * 100).round().clamp(-127, 127).to(torch.int8)
                  if a.ndim >= 2 else a, params),
              "scales": _tree.tree_map(
                  lambda a: torch.tensor(0.01) if a.ndim >= 2
                  else torch.zeros(0), params)}
        with tperf.variant(tperf.PerfVariant(int8_weights=True)):
            step = tsteps.make_serve_step(cfg)
        cache = tapi.init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
        got, _ = step(pq, cache, toks[:, :1])
        want, _ = tapi.serve_step(tsteps.dequantize_params(pq), cfg,
                                  toks[:, :1], cache)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_microbatches_sum_the_gradients_in_order():
    """With n microbatches the loss and gradients are the sums over the
    n parts, in order from zero, divided by n: equal bit for bit to that
    sum made by hand from the single-batch function."""
    name = "qwen3-1.7b"
    cfg = REGISTRY[name].reduced()
    params = tapi.params_from_numpy(ref_params(name), "cpu")
    batch = {k: t(v) for k, v in train_batch(cfg).items()}
    one = tsteps.make_loss_and_grads(cfg, SEQ)
    loss, grads = tsteps.make_loss_and_grads(cfg, SEQ, microbatches=2)(
        params, batch)
    parts = [one(params, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
             for i in range(2)]
    assert torch.equal(loss, (torch.zeros(()) + parts[0][0] + parts[1][0]) / 2)
    for (path, g), g0, g1 in zip(_tree.leaves_with_path(grads),
                                 _tree.leaves(parts[0][1]),
                                 _tree.leaves(parts[1][1])):
        assert torch.equal(g, (torch.zeros_like(g0) + g0 + g1) / 2), path


def test_ssd_gradient_stays_finite_where_the_references_overflows():
    """The SSD intra-chunk decay ``exp(diff)`` overflows above the
    diagonal once ``dt * |a|`` sums past ~88 within a chunk (mamba2 trains
    into that regime in a few steps).  The reference masks after the exp,
    so its gradient there is NaN; the port masks before it.  Forward and
    gradients equal the reference's where nothing overflows; the forward
    also where it does, and the port's gradient stays finite there."""
    from repro.models import mamba2 as jm
    from repro_torch.models import mamba2 as tm

    rng = np.random.default_rng(5)
    x, b_in, c_in, w = (rng.standard_normal(s).astype(np.float32) for s in
                        ((2, 16, 3, 4), (2, 16, 5), (2, 16, 5), (2, 16, 3, 4)))
    a = -np.array([1.0, 4.0, 16.0], np.float32)
    for scale, overflows in ((0.01, False), (10.0, True)):
        dt = (scale * rng.uniform(0.5, 1.0, (2, 16, 3))).astype(np.float32)

        def jloss(args):
            y, _ = jm.ssd_chunked(*args[:2], jnp.asarray(a), *args[2:], 8)
            return jnp.sum(y * w), y

        jargs = tuple(jnp.asarray(v) for v in (x, dt, b_in, c_in))
        (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jargs)
        targs = [torch.tensor(v, requires_grad=True)
                 for v in (x, dt, b_in, c_in)]
        ty, _ = tm.ssd_chunked(*targs[:2], torch.tensor(a), *targs[2:], 8)
        (ty * torch.tensor(w)).sum().backward()
        assert np.allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5,
                           atol=1e-6)
        assert any(np.isnan(np.asarray(g)).any() for g in jg) == overflows
        for got, want in zip(targs, jg):
            assert torch.isfinite(got.grad).all()
            if not overflows:
                assert np.allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
