"""Port parity, the fused layer-step stages: ``delta_encode_step`` (the IPU
stage: concatenate, encode, masked write-back of the reference state) and
``lstm_pointwise_step`` (accumulate, HPE, masked write-back of dm, c, h).

Their plain versions must be bit-equal to the unfused composition the
engines ran before (``torch.cat`` / ``delta_encode_ref`` / add /
``lstm_pointwise_ref`` / ``torch.where``), so every parity test of the
port against the JAX package sees the same numbers; they must agree with
the JAX package's ``ops.delta_encode_batch`` / ``ops.lstm_pointwise_batch``
(Pallas in interpret mode, as tests/test_kernels.py runs them) followed by
``jnp.where`` at 1e-6 with exact fired counts; and a slot left out must
come back bit for bit, -0.0 and NaN payloads included.  The CUDA kernels
are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import delta_encode as tde
from repro_torch.kernels import lstm_pointwise as tlp
from repro_torch.kernels import ops, ref
from repro_torch.models import lstm_am
from repro_torch.serving import BatchedSpartusEngine, EngineConfig
from repro_torch.serving import batched_engine, engine

B = 5
ACTIVE = {"null": None, "all": [1] * B, "none": [0] * B,
          "mixed": [1, 0, 1, 1, 0]}


def _active(mode):
    a = ACTIVE[mode]
    return None if a is None else torch.tensor(a, dtype=torch.bool)


def _bits(t):
    """Bit pattern, so NaN payloads and -0.0 compare exactly."""
    return t.contiguous().view(torch.int32)


def _poison(t):
    """A -0.0 and a NaN with a payload in every row of a state tensor."""
    t[:, 0] = -0.0
    t[:, -1] = torch.tensor(0x7FC01234, dtype=torch.int32).view(
        torch.float32)
    return t


def _encode_inputs(d, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    hid = rng.standard_normal((B, h)).astype(np.float32)
    s_hat = (np.concatenate([x, hid], -1)
             + rng.standard_normal((B, d + h)) * 0.3).astype(np.float32)
    return x, hid, s_hat


def _unfused_encode(x, h, s_hat, theta, active, act_bits):
    """The batched engine's IPU glue as it was: cat, encode, where, copy_."""
    s = torch.cat([x, h], dim=-1)
    delta, new, nnz = ref.delta_encode_ref(s, s_hat, theta, act_bits)
    if active is None:
        s_hat.copy_(new)
    else:
        s_hat.copy_(torch.where(active[:, None], new, s_hat))
    return delta, nnz


@pytest.mark.parametrize("d,h", [(123, 128), (123, 1024), (0, 128),
                                 (0, 1024)])
@pytest.mark.parametrize("act_bits", [None, 16])
@pytest.mark.parametrize("mode", list(ACTIVE))
def test_delta_encode_step_plain_equals_unfused(d, h, act_bits, mode):
    x, hid, s_hat = (torch.from_numpy(a)
                     for a in _encode_inputs(d, h, d + h))
    active = _active(mode)
    want_state = _poison(s_hat.clone())
    got_state = want_state.clone()
    before = tde.KERNEL.launches
    want = _unfused_encode(x, hid, want_state, 0.3, active, act_bits)
    got = ops.delta_encode_step(x, hid, got_state, 0.3, active=active,
                                act_bits=act_bits)
    assert tde.KERNEL.launches == before       # a CPU tensor never launches
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert torch.equal(_bits(got_state), _bits(want_state))
    if mode in ("none", "mixed"):
        off = ~torch.tensor(ACTIVE[mode], dtype=torch.bool)
        assert torch.equal(_bits(got_state[off]), _bits(_poison(
            s_hat.clone())[off]))


def _unfused_hpe(dm, y, c, h, active):
    """The batched engine's HPE glue as it was: add, HPE, where, copy_."""
    b, hidden = c.shape
    dm_new = dm + y
    h_new, c_new = ref.lstm_pointwise_ref(dm_new.view(b, 4, hidden), c)
    if active is None:
        c.copy_(c_new), h.copy_(h_new), dm.copy_(dm_new)
    else:
        am = active[:, None]
        c.copy_(torch.where(am, c_new, c))
        h.copy_(torch.where(am, h_new, h))
        dm.copy_(torch.where(am, dm_new, dm))
    return h_new


def _hpe_inputs(h, seed, amp=4.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * a)
                             .astype(np.float32))
            for shape, a in (((B, 4 * h), amp), ((B, 4 * h), 1.0),
                             ((B, h), 2.0), ((B, h), 1.0))]


@pytest.mark.parametrize("h", [128, 1024])
@pytest.mark.parametrize("mode", list(ACTIVE))
def test_lstm_pointwise_step_plain_equals_unfused(h, mode):
    dm, y, c, hid = _hpe_inputs(h, h)
    active = _active(mode)
    want_state = [_poison(t.clone()) for t in (dm, c, hid)]
    got_state = [t.clone() for t in want_state]
    before = tlp.KERNEL.launches
    want = _unfused_hpe(want_state[0], y, want_state[1], want_state[2],
                        active)
    got = ops.lstm_pointwise_step(got_state[0], y, got_state[1],
                                  got_state[2], active=active)
    assert tlp.KERNEL.launches == before
    assert torch.equal(_bits(got), _bits(want))
    for g, w in zip(got_state, want_state):
        assert torch.equal(_bits(g), _bits(w))
    if mode == "none":
        for g, t in zip(got_state, (dm, c, hid)):
            assert torch.equal(_bits(g), _bits(_poison(t.clone())))


@pytest.mark.parametrize("d,h", [(123, 128), (0, 256)])
@pytest.mark.parametrize("act_bits", [None, 16])
def test_delta_encode_step_vs_reference_ops(d, h, act_bits):
    """== the reference's vmapped Pallas encoder on the concatenated
    state, then ``jnp.where`` on the active slots."""
    x, hid, s_hat = _encode_inputs(d, h, 7 + d)
    mask = np.array(ACTIVE["mixed"], bool)
    kw = {} if act_bits is None else {"act_bits": act_bits}
    jd, jx, jn = jops.delta_encode_batch(
        jnp.asarray(np.concatenate([x, hid], -1)), jnp.asarray(s_hat), 0.3,
        use_pallas=True, **kw)
    j_state = jnp.where(jnp.asarray(mask)[:, None], jx, jnp.asarray(s_hat))
    state = torch.from_numpy(s_hat.copy())
    td, tn = ops.delta_encode_step(torch.from_numpy(x), torch.from_numpy(hid),
                                   state, 0.3,
                                   active=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(j_state), state.numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


@pytest.mark.parametrize("h", [128, 700])
def test_lstm_pointwise_step_vs_reference_ops(h):
    """== the reference's dm + y, vmapped Pallas HPE, then ``jnp.where``
    on the active slots."""
    dm, y, c, hid = (t.numpy() for t in _hpe_inputs(h, 3 + h))
    mask = jnp.asarray(np.array(ACTIVE["mixed"], bool))[:, None]
    j_dm = jnp.asarray(dm) + jnp.asarray(y)
    jh, jc = jops.lstm_pointwise_batch(j_dm.reshape(B, 4, h), jnp.asarray(c),
                                       use_pallas=True)
    want = {"dm": jnp.where(mask, j_dm, dm), "c": jnp.where(mask, jc, c),
            "h": jnp.where(mask, jh, hid)}
    state = {k: torch.from_numpy(v.copy())
             for k, v in (("dm", dm), ("c", c), ("h", hid))}
    th = ops.lstm_pointwise_step(state["dm"], torch.from_numpy(y),
                                 state["c"], state["h"],
                                 active=torch.from_numpy(np.asarray(
                                     ACTIVE["mixed"], bool)))
    np.testing.assert_allclose(np.asarray(jh), th.numpy(), atol=1e-6)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(v), state[k].numpy(),
                                   atol=1e-6)


def test_step_core_has_no_glue_left():
    """The pool step goes through the fused entry points: no concatenate,
    accumulate or masked write-back of its own (and no host sync)."""
    core = inspect.getsource(batched_engine.BatchedSpartusEngine._step_core)
    layer = inspect.getsource(engine._step_layer)
    for src in (core, layer):
        assert "ops.delta_encode_step(" in src
        assert "ops.lstm_pointwise_step(" in src
        for glue in ("torch.cat", "torch.where", "s_hat.copy_", ".c.copy_",
                     ".h.copy_", ".dm.copy_", "dm + y"):
            assert glue not in src, glue
    for sync in (".item()", ".cpu()", ".tolist()", "int(", "float("):
        assert sync not in core, sync


def test_pool_step_leaves_inactive_slots_bit_unchanged():
    """An inactive slot's whole layer state (s_hat, c, h, dm) survives a
    pool step bit for bit, -0.0 and NaN payloads included, while active
    slots advance."""
    cfg = lstm_am.LSTMAMConfig(input_dim=12, hidden_dim=16, n_layers=2,
                               n_classes=5)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu"), gamma=0.75, m=4)
    for route in ("scatter", "dense"):
        eng = BatchedSpartusEngine(params, cfg, EngineConfig(
            theta=0.05, gamma=0.75, m=4, spmv_path=route), device="cpu")
        state = eng.init_state(3)
        for st in state.layers:
            for t in st:
                _poison(t)
        before = [_bits(t).clone() for st in state.layers for t in st]
        x = torch.randn((3, 12), generator=torch.Generator().manual_seed(1))
        eng.step_batch(state, x, [True, False, True])
        after = [_bits(t) for st in state.layers for t in st]
        for b, a in zip(before, after):
            assert torch.equal(a[1], b[1])
            assert not torch.equal(a[[0, 2]], b[[0, 2]])
