"""Port parity, the model zoo's loss, gradients and CBTD layout on the CPU,
for all 10 registry architectures at ``.reduced()`` widths (reference
params carried across as numpy, seeded numpy batches).

- ``train_loss`` within 1e-5 * |reference| + 1e-6, and autograd's
  gradients against ``jax.grad`` leaf for leaf, each within 1e-4 of the
  leaf's largest reference gradient; again with ``remat`` and
  ``q_chunk`` on;
- ``cbtd_layout`` equal to the reference's, and ``cbtd_prune_tree``
  (``repro_torch.core.cbtd``) applied through it equal to the
  reference's pruned tree, zeros and all;
- ``make_train_batch``'s keys, shapes and ranges.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cbtd import cbtd_prune_tree as jprune
from repro.models import api as japi
from repro_torch import _tree
from repro_torch.core.cbtd import cbtd_prune_tree as tprune
from repro_torch.models import api as tapi
from torch_zoo_parity import (
    ARCHS,
    GRAD_REL,
    assert_close,
    both_params,
    configs,
    ref_params,
    seq_inputs,
    t,
)


def _batch(cfg, seed):
    """A numpy train batch of the family's keys (B=2, S=32)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": seq_inputs(cfg, 2, 32, seed),
                "dec_tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
                "dec_targets": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    key = "inputs_embeds" if cfg.family == "vlm" else "tokens"
    x = seq_inputs(cfg, 2, 32, seed) if cfg.family == "vlm" else toks[:, :-1]
    return {key: x, "targets": toks[:, 1:]}


def _loss_and_grads_match(name, **kwargs):
    jcfg, tcfg = configs(name)
    jp, tp = both_params(name)
    batch = _batch(jcfg, seed=7)
    want, jgrads = jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, jax.tree.map(jnp.asarray, batch),
                                  **kwargs))(jp)
    tp = _tree.tree_map(lambda a: a.requires_grad_(True), tp)
    got = tapi.train_loss(tp, tcfg, {k: t(v) for k, v in batch.items()},
                          **kwargs)
    got.backward()
    assert_close(got, want, f"{name} loss")
    jflat = dict(_tree.leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    tflat = _tree.leaves_with_path(tp)
    assert [p for p, _ in tflat] == list(jflat)
    for path, leaf in tflat:
        want_g = jflat[path]
        got_g = (leaf.grad if leaf.grad is not None
                 else torch.zeros_like(leaf))
        assert_close(got_g, want_g, f"{name} grad {path}", rel=GRAD_REL,
                     abs_=1e-12)
    assert any(float(np.max(np.abs(g))) > 0 for g in jflat.values())


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_gradients_match_reference(name):
    _loss_and_grads_match(name)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "seamless-m4t-medium",
                                  "recurrentgemma-9b"])
def test_remat_and_q_chunk_loss_and_gradients_match_reference(name):
    """``remat`` (activations recomputed in the backward pass) and
    ``q_chunk=8`` (the q-chunk loop; the windowed kv slab for the
    hybrid) on both sides."""
    _loss_and_grads_match(name, q_chunk=8, remat=True)


@pytest.mark.parametrize("name", ARCHS)
def test_cbtd_layout_and_prune_match_reference(name):
    jcfg, tcfg = configs(name)
    jlayout = japi.cbtd_layout(jcfg, gamma=0.5, m=4)
    tlayout = tapi.cbtd_layout(tcfg, gamma=0.5, m=4)
    assert list(tlayout) == list(jlayout)
    for pat in jlayout:
        assert (dataclasses.asdict(tlayout[pat])
                == dataclasses.asdict(jlayout[pat]))
    jp, tp = both_params(name)
    want = dict(_tree.leaves_with_path(jax.tree.map(
        np.asarray, jprune(jp, jlayout, alpha=1.0))))
    got = _tree.leaves_with_path(tprune(tp, tlayout, alpha=1.0))
    assert [p for p, _ in got] == list(want)
    n_pruned = 0
    for path, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
        n_pruned += int(leaf.ndim >= 2 and bool((leaf == 0).any()))
    assert n_pruned >= 2
    np.testing.assert_array_equal(dict(got)["embed"].numpy(),
                                  ref_params(name)["embed"])


@pytest.mark.parametrize("family_arch", ["qwen2-0.5b", "pixtral-12b",
                                         "seamless-m4t-medium"])
def test_make_train_batch_shapes(family_arch):
    jcfg, cfg = configs(family_arch)
    want = japi.make_train_batch(jcfg, jax.random.key(0), batch=2, seq=32)
    got = tapi.make_train_batch(cfg, torch.Generator().manual_seed(0), 2, 32)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if not got[k].is_floating_point():
            assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab
    if cfg.family == "audio":               # one key draws both there
        assert np.array_equal(np.asarray(want["dec_tokens"]),
                              np.asarray(want["dec_targets"]))
        assert torch.equal(got["dec_tokens"], got["dec_targets"])
    else:
        loss = tapi.train_loss(tapi.init_params(
            cfg, torch.Generator().manual_seed(1), device="cpu"), cfg, got)
        assert torch.isfinite(loss)


def test_chunked_ce_loss_and_its_gradient_match_reference():
    """The sequence-chunked CE (each chunk's logits recomputed in the
    backward pass), at chunk 8 over S=32, and the full-logit CE."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((40, 16)).astype(np.float32)
    tgt = rng.integers(0, 40, (2, 32)).astype(np.int32)
    for chunk in (8, 512):
        want, want_gw = jax.value_and_grad(
            lambda w_: jtransformer.chunked_ce_loss(
                jnp.asarray(x), w_, jnp.asarray(tgt), chunk=chunk))(
                    jnp.asarray(w))
        tw = t(w).requires_grad_(True)
        got = ttransformer.chunked_ce_loss(t(x), tw, t(tgt), chunk=chunk)
        got.backward()
        assert_close(got, want, f"chunked ce {chunk}")
        assert_close(tw.grad, want_gw, f"chunked ce grad {chunk}",
                     rel=GRAD_REL, abs_=1e-12)
