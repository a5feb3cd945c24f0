"""Port parity, DeltaGRU and DeltaLinear: repro_torch.core.delta_gru /
delta_linear against the JAX reference on the same parameters (the
reference's seeded init carried across as numpy) and the same numpy
inputs.

Tolerances: 1e-6 for outputs and state, absolute plus 1e-6 relative to
the value (the same math, matrix-vector products summed in another
order: DeltaLinear's running output reaches |y| ~ 2.6, where one fp32 ulp
is 2.4e-7, and 20 steps accumulate a few ulps); the fired counts
(``nnz_dx``, ``nnz_dh``) exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_gru as jgru
from repro.core import delta_linear as jlin
from repro_torch import core as tcore

TOL = 1e-6       # absolute, and relative to the value
D, H, T = 16, 24, 20


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _smooth(seed, shape, tau=0.8):
    """A first-order autoregressive signal along axis 0 (speech-like:
    consecutive frames close, so the thresholds bite)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(shape, np.float32)
    x[0] = rng.standard_normal(shape[1:])
    for t in range(1, shape[0]):
        x[t] = tau * x[t - 1] + (1 - tau) * rng.standard_normal(shape[1:])
    return x.astype(np.float32)


def _gru_params(seed, biased):
    p = jax.device_get(jgru.init_gru_params(jax.random.key(seed), D, H))
    if biased:
        rng = np.random.default_rng(seed)
        p = dict(p, b_x=(0.3 * rng.standard_normal((3, H))).astype(np.float32),
                 b_h=(0.3 * rng.standard_normal((3, H))).astype(np.float32))
    return {k: np.asarray(v) for k, v in p.items()}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("biased", [False, True])
def test_gru_layer_matches_reference(biased):
    p = _gru_params(1, biased)
    xs = _smooth(2, (T, D))
    want = jgru.gru_layer({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(xs))
    got = tcore.gru_layer({k: _t(v) for k, v in p.items()}, _t(xs))
    _close(want, got)


@pytest.mark.parametrize("theta", [0.0, 0.05, 0.2])
@pytest.mark.parametrize("biased", [False, True])
def test_delta_gru_layer_matches_reference(theta, biased):
    p = _gru_params(3, biased)
    xs = _smooth(4, (T, D))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jhs, jstate, jaux = jgru.delta_gru_layer(jp, jnp.asarray(xs), theta)
    ths, tstate, taux = tcore.delta_gru_layer(tp, _t(xs), theta)
    _close(jhs, ths)
    for f in jgru.DeltaGRUState._fields:
        _close(getattr(jstate, f), getattr(tstate, f))
    for k in ("nnz_dx", "nnz_dh"):
        np.testing.assert_array_equal(np.asarray(jaux[k]), taux[k].numpy())
    if theta > 0:
        assert int(taux["nnz_dx"].sum()) < T * D     # the threshold bit


def test_delta_gru_step_from_a_carried_state_matches_reference():
    p = _gru_params(5, True)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    xs = _smooth(6, (2 * T, D))
    _, jstate, _ = jgru.delta_gru_layer(jp, jnp.asarray(xs[:T]), 0.1)
    state = tcore.DeltaGRUState(*(_t(np.asarray(a)) for a in jstate))
    jnew, jh, jaux = jgru.delta_gru_step(jp, jstate, jnp.asarray(xs[T]), 0.1)
    tnew, th, taux = tcore.delta_gru_step(tp, state, _t(xs[T]), 0.1)
    _close(jh, th)
    for a, b in zip(jnew, tnew):
        _close(a, b)
    assert int(jaux["nnz_dx"]) == int(taux["nnz_dx"])
    assert int(jaux["nnz_dh"]) == int(taux["nnz_dh"])


def test_delta_gru_batch_rows_are_independent_sessions():
    """The port's layers take leading batch dims: each row of a [B, T, D]
    run equals that row run alone, and equals the reference."""
    p = _gru_params(7, True)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    xs = np.stack([_smooth(10 + b, (T, D)) for b in range(3)])
    hs, state, aux = tcore.delta_gru_layer(tp, _t(xs), 0.1)
    assert hs.shape == (3, T, H) and aux["nnz_dx"].shape == (3, T)
    for b in range(3):
        jhs, _, jaux = jgru.delta_gru_layer(jp, jnp.asarray(xs[b]), 0.1)
        _close(jhs, hs[b])
        np.testing.assert_array_equal(np.asarray(jaux["nnz_dh"]),
                                      aux["nnz_dh"][b].numpy())


def test_delta_gru_at_theta_zero_is_the_gru():
    p = {k: _t(v) for k, v in _gru_params(9, True).items()}
    xs = _t(_smooth(11, (T, D)))
    hs, _, _ = tcore.delta_gru_layer(p, xs, 0.0)
    torch.testing.assert_close(hs, tcore.gru_layer(p, xs), rtol=0,
                               atol=1e-5)


def test_delta_gru_state_fields_own_their_storage():
    p = {k: _t(v) for k, v in _gru_params(12, True).items()}
    state = tcore.init_delta_gru_state(D, H, p, batch_shape=(2,))
    ptrs = [t.untyped_storage().data_ptr() for t in state]
    ptrs += [t.untyped_storage().data_ptr() for t in p.values()]
    assert len(set(ptrs)) == len(ptrs)
    assert state.m_r.shape == (2, H) and state.x_hat.shape == (2, D)
    torch.testing.assert_close(state.m_hc[1], p["b_h"][2])


@pytest.mark.parametrize("theta", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_delta_linear_over_time_matches_reference(theta, batch):
    o = 12
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((o, D)) / np.sqrt(D)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    xs = _smooth(14, (T,) + batch + (D,))
    jys, jstate, jaux = jlin.delta_linear_over_time(
        jnp.asarray(w), jnp.asarray(xs), theta, bias=jnp.asarray(bias))
    tys, tstate, taux = tcore.delta_linear_over_time(
        _t(w), _t(xs), theta, bias=_t(bias))
    assert tys.shape == (T,) + batch + (o,)
    _close(jys, tys)
    _close(jstate.x_hat, tstate.x_hat)
    _close(jstate.y, tstate.y)
    np.testing.assert_array_equal(np.asarray(jaux["nnz_dx"]),
                                  taux["nnz_dx"].numpy())
    if theta == 0.0:
        torch.testing.assert_close(tys, _t(xs) @ _t(w).T + _t(bias),
                                   rtol=0, atol=1e-5)


def test_delta_linear_step_from_a_carried_state_matches_reference():
    rng = np.random.default_rng(15)
    w = (rng.standard_normal((8, D)) / np.sqrt(D)).astype(np.float32)
    xs = _smooth(16, (T + 1, 2, D))
    _, jstate, _ = jlin.delta_linear_over_time(jnp.asarray(w),
                                               jnp.asarray(xs[:T]), 0.1)
    state = tcore.DeltaLinearState(*(_t(np.asarray(a)) for a in jstate))
    jnew, jy, jaux = jlin.delta_linear_step(jnp.asarray(w), jstate,
                                            jnp.asarray(xs[T]), 0.1)
    tnew, ty, taux = tcore.delta_linear_step(_t(w), state, _t(xs[T]), 0.1)
    _close(jy, ty)
    _close(jnew.x_hat, tnew.x_hat)
    np.testing.assert_array_equal(np.asarray(jaux["nnz_dx"]),
                                  taux["nnz_dx"].numpy())
