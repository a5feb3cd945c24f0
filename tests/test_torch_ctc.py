"""Port parity, CTC: repro_torch.training.ctc against the JAX reference on
the same numpy logits and labels (loss and gradient within 1e-5, the
brute-force alignment sum on tiny cases, greedy decoding, edit distance
and PER equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import ctc as jctc
from repro_torch.training import ctc as tctc

TOL = 1e-5


def _case(seed, b, t, v, l):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, t, v))).astype(np.float32)
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    return logits, labels


def _both(logits, labels, logit_lens, label_lens):
    """(loss, grad) of the reference and of the port."""
    def ref(x):
        return jctc.ctc_loss(x, jnp.asarray(labels), jnp.asarray(logit_lens),
                             jnp.asarray(label_lens))
    lj, gj = jax.value_and_grad(ref)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    lt = tctc.ctc_loss(x, torch.tensor(labels), torch.tensor(logit_lens),
                       torch.tensor(label_lens))
    gt, = torch.autograd.grad(lt, x)
    return (float(lj), np.asarray(gj)), (float(lt.detach()), gt.numpy())


@pytest.mark.parametrize("b,t,v,l", [(4, 12, 6, 5), (3, 40, 41, 16),
                                     (2, 7, 3, 3)])
def test_loss_and_gradient_match_reference(b, t, v, l):
    logits, labels = _case(b * t + v, b, t, v, l)
    rng = np.random.default_rng(l)
    logit_lens = rng.integers(t // 2, t + 1, b).astype(np.int32)
    logit_lens[0] = t
    label_lens = rng.integers(0, l + 1, b).astype(np.int32)
    label_lens[0] = min(l, t // 2)
    labels[-1, :2] = labels[-1, 0]            # a repeat: no blank skip
    (lj, gj), (lt, gt) = _both(logits, labels, logit_lens, label_lens)
    assert lt == pytest.approx(lj, rel=TOL, abs=TOL)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, atol=TOL, rtol=0)


def test_empty_labels_match_reference():
    """label_len 0: the all-blank path only, selected by torch.where."""
    logits, labels = _case(7, 2, 6, 4, 3)
    (lj, gj), (lt, gt) = _both(logits, labels, np.array([6, 4], np.int32),
                               np.array([0, 0], np.int32))
    assert lt == pytest.approx(lj, rel=TOL)
    np.testing.assert_allclose(gt, gj, atol=TOL, rtol=0)


def test_impossible_alignment_is_huge_with_finite_gradient():
    """Labels longer than the frames allow: a loss near -NEG_INF in both,
    and (the reason NEG_INF is finite) a finite gradient that sums to 0
    over each frame's classes, as a softmax gradient does."""
    logits, labels = _case(8, 1, 2, 4, 3)
    (lj, _), (lt, gt) = _both(logits, labels, np.array([2], np.int32),
                              np.array([3], np.int32))
    assert lt > 1e20 and lj > 1e20
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt.sum(-1), 0.0, atol=1e-5)


@pytest.mark.parametrize("t,v,l", [(3, 3, 1), (4, 3, 2), (5, 4, 2),
                                   (6, 3, 3)])
def test_matches_brute_force(t, v, l):
    logits, labels = _case(t * 100 + v * 10 + l, 1, t, v, l)
    log_probs = torch.log_softmax(torch.tensor(logits[0]), -1).numpy()
    expect = tctc.ctc_loss_brute_force(log_probs, labels[0])
    assert expect == pytest.approx(
        jctc.ctc_loss_brute_force(log_probs, labels[0]), rel=1e-12)
    got = float(tctc.ctc_loss(torch.tensor(logits), torch.tensor(labels),
                              torch.tensor([t]), torch.tensor([l])))
    assert got == pytest.approx(expect, rel=1e-4)


def test_padded_frames_and_labels_ignored():
    logits, labels = _case(3, 1, 5, 4, 2)
    base = float(tctc.ctc_loss(torch.tensor(logits), torch.tensor(labels),
                               torch.tensor([5]), torch.tensor([2])))
    padded = np.concatenate([logits, 9 * np.ones((1, 3, 4), np.float32)], 1)
    plabels = np.concatenate([labels, np.array([[3, 1]], np.int32)], 1)
    got = float(tctc.ctc_loss(torch.tensor(padded), torch.tensor(plabels),
                              torch.tensor([5]), torch.tensor([2])))
    assert got == pytest.approx(base, rel=1e-6)


def test_greedy_decode_edit_distance_and_per_equal():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 30, 5)).astype(np.float32)
    logits[:, ::3, 0] += 3.0                   # blanks between repeats
    logits[0, 4:9, 2] += 9.0                   # a run that collapses
    logits[1, :, 1] = logits[1, :, 3]          # ties: the first index wins
    lens = np.array([30, 17, 1, 0, 30, 22], np.int32)
    want = jctc.greedy_decode(jnp.asarray(logits), jnp.asarray(lens))
    got = tctc.greedy_decode(torch.tensor(logits), torch.tensor(lens))
    assert got == want
    refs = [list(rng.integers(1, 5, n)) for n in (4, 0, 7, 2, 9, 1)]
    for h, r in zip(got, refs):
        assert tctc.edit_distance(h, r) == jctc.edit_distance(h, r)
    assert tctc.phone_error_rate(got, refs) == jctc.phone_error_rate(got,
                                                                      refs)
    assert tctc.edit_distance([1, 2, 3], [1, 3]) == 1
