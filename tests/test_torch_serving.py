"""Port parity, serving: repro_torch.serving against the JAX package's
engines on the same weights and frames (H=32, D=20, 2 layers, gamma=0.75,
m=4, as tests/test_chunked_serving.py).  That model routes to the dense
mirror under "auto", so every serving case runs on both SpMV routes.

Tolerances: the packed arrays are bit-equal (fp32 and int8); logits are
within 1e-5 of the reference (same math, another summation order) and of
the port's own batch-1 engine; quantized logits are within the
reference's 0.05 quant gate of the reference's quantized logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import QuantConfig as JQuant
from repro.models import lstm_am as jam
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro.serving import SpartusEngine as JEngine
from repro.serving import serve_requests as jserve
from repro_torch.core.quantization import QuantConfig as TQuant
from repro_torch.models import lstm_am as tam
from repro_torch.serving import BatchedSpartusEngine as TBatched
from repro_torch.serving import EngineConfig as TConfig
from repro_torch.serving import SpartusEngine as TEngine
from repro_torch.serving import serve_requests as tserve
from repro_torch.serving.scheduler import SessionPool, StreamRequest

INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
GAMMA, M, THETA = 0.75, 4, 0.05
ROUTES = ["scatter", "dense"]
QUANT_GATE = 0.05


@pytest.fixture(scope="module")
def model():
    jcfg = jam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    tcfg = tam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    params = jam.cbtd_prune_stacks(jam.init_params(jax.random.key(0), jcfg),
                                   gamma=GAMMA, m=M)
    tparams = tam.params_from_numpy(jax.device_get(params), device="cpu")
    return params, jcfg, tparams, tcfg


def _configs(route, quant=False, capacity_frac=1.0):
    kw = dict(theta=THETA, gamma=GAMMA, m=M, capacity_frac=capacity_frac,
              spmv_path=route)
    return (JConfig(quant=JQuant() if quant else None, **kw),
            TConfig(quant=TQuant() if quant else None, **kw))


def _feats(seed, t):
    return np.random.default_rng(seed).standard_normal(
        (t, INPUT_DIM)).astype(np.float32)


# -- packing -------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("quant", [False, True])
def test_packed_arrays_bit_equal(model, route, quant):
    params, jcfg, tparams, tcfg = model
    jc, tc = _configs(route, quant, capacity_frac=0.5)
    je, te = JEngine(params, jcfg, jc), TEngine(tparams, tcfg, tc, device="cpu")
    for jl, tl in zip(je.layers, te.layers):
        for a in ("val", "lidx", "valid"):
            ja, ta = np.asarray(getattr(jl.enc, a)), getattr(tl.enc, a).numpy()
            assert ja.dtype == ta.dtype
            np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(np.asarray(jl.scale), tl.scale.numpy())
        assert (jl.w_dense_t is None) == (tl.w_dense_t is None)
        if tl.w_dense_t is not None:
            np.testing.assert_array_equal(np.asarray(jl.w_dense_t),
                                          tl.w_dense_t.numpy())
            assert tl.w_dense_t.dtype == (torch.int8 if quant
                                          else torch.float32)
        assert (jl.capacity, jl.pack_overflow, jl.input_dim, jl.hidden_dim) \
            == (tl.capacity, tl.pack_overflow, tl.input_dim, tl.hidden_dim)
    assert te.weight_bytes() == je.weight_bytes()
    assert te.weight_payload_bytes() == je.weight_payload_bytes()
    assert te.pack_overflow_count() == je.pack_overflow_count()
    assert te.weight_sparsity() == pytest.approx(je.weight_sparsity(),
                                                 abs=1e-12)


@pytest.mark.parametrize("route", ROUTES)
def test_quant_payload_is_four_times_smaller(model, route):
    params, jcfg, tparams, tcfg = model
    fp = TEngine(tparams, tcfg, _configs(route)[1], device="cpu")
    q8 = TEngine(tparams, tcfg, _configs(route, quant=True)[1], device="cpu")
    assert fp.weight_payload_bytes() == 4 * q8.weight_payload_bytes()


def test_spmv_path_validated(model):
    _, _, tparams, tcfg = model
    with pytest.raises(ValueError, match="spmv_path"):
        TEngine(tparams, tcfg, TConfig(spmv_path="sparse"), device="cpu")


# -- batch-1 engine ------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("quant", [False, True])
def test_run_utterance_matches_reference(model, route, quant):
    params, jcfg, tparams, tcfg = model
    jc, tc = _configs(route, quant, capacity_frac=0.3)
    je, te = JEngine(params, jcfg, jc), TEngine(tparams, tcfg, tc, device="cpu")
    feats = _feats(1, 14)
    jl = np.asarray(je.run_utterance(jnp.asarray(feats)))
    tl = te.run_utterance(feats).numpy()
    gap = float(np.abs(jl - tl).max())
    assert gap <= (QUANT_GATE if quant else 1e-5), gap
    assert [(t["nnz"], t["dropped"]) for t in te.telemetry] == \
        [(t["nnz"], t["dropped"]) for t in je.telemetry]
    assert te.measured_sparsity() == je.measured_sparsity()
    assert te.measured_sparsity()["capacity_overflow_rate"] > 0


# -- pool ----------------------------------------------------------------------


def _requests(lengths, stride):
    """``(arrival_step, feats)`` pairs: both packages' serve_requests take
    them (request i gets req_id i)."""
    return [(i * stride, _feats(100 + i, t)) for i, t in enumerate(lengths)]


GRID = [  # (capacity, chunk_frames, max_steps)
    (2, 0, None),
    (3, 4, None),
    (4, 8, None),
    (2, 0, 9),
    (3, 4, 9),
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("capacity,chunk,max_steps", GRID)
def test_serve_requests_matches_reference(model, route, capacity, chunk,
                                          max_steps):
    """Ragged lengths, staggered arrivals, backpressure; per-frame and
    chunked; with and without a max_steps cut."""
    params, jcfg, tparams, tcfg = model
    jc, tc = _configs(route, capacity_frac=0.5)
    reqs = _requests([7, 3, 11, 5, 9], stride=2)
    jr, js = jserve(JBatched(params, jcfg, jc), reqs, capacity,
                    max_steps=max_steps, chunk_frames=chunk)
    te = TBatched(tparams, tcfg, tc, device="cpu")
    tr, ts = tserve(te, reqs, capacity, max_steps=max_steps,
                    chunk_frames=chunk)
    assert [r.req_id for r in tr] == [r.req_id for r in jr]
    for a, b in zip(jr, tr):
        assert a.logits.shape == b.logits.shape
        np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)
        assert (a.truncated, a.admit_step, a.finish_step) == \
            (b.truncated, b.admit_step, b.finish_step)
    for f in ("total_frames", "total_steps", "truncated", "n_dispatches",
              "capacity", "n_requests"):
        assert getattr(ts, f) == getattr(js, f), f
    assert round(ts.bytes_per_slot * ts.capacity) == \
        round(js.bytes_per_slot * js.capacity)
    for k, v in js.sparsity.items():
        assert ts.sparsity[k] == pytest.approx(v, abs=1e-7)
    if max_steps is not None:
        assert ts.truncated


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("chunk", [0, 4])
def test_quantized_pool_within_quant_gate(model, route, chunk):
    params, jcfg, tparams, tcfg = model
    jc, tc = _configs(route, quant=True, capacity_frac=0.5)
    reqs = _requests([6, 9, 4], stride=1)
    jr, _ = jserve(JBatched(params, jcfg, jc), reqs, 2, chunk_frames=chunk)
    tr, _ = tserve(TBatched(tparams, tcfg, tc, device="cpu"), reqs, 2,
                   chunk_frames=chunk)
    gap = max(float(np.abs(a.logits - b.logits).max())
              for a, b in zip(jr, tr))
    assert gap <= QUANT_GATE, gap


@pytest.mark.parametrize("route", ROUTES)
def test_pool_matches_port_batch1(model, route):
    _, _, tparams, tcfg = model
    tc = _configs(route, capacity_frac=0.5)[1]
    eng = TEngine(tparams, tcfg, tc, device="cpu")
    reqs = _requests([8, 5, 10], stride=0)
    res, _ = tserve(TBatched(tparams, tcfg, tc, device="cpu"), reqs, 2,
                    chunk_frames=4)
    for r, (_, feats) in zip(res, reqs):
        np.testing.assert_allclose(
            r.logits, eng.run_utterance(feats).numpy(), atol=1e-5)


def test_step_chunk_matches_step_frames_in_place(model):
    """One chunk == the same frames stepped one at a time; both update the
    preallocated PoolState in place."""
    _, _, tparams, tcfg = model
    eb = TBatched(tparams, tcfg, _configs("scatter")[1], device="cpu")
    lens = np.array([7, 4, 6], np.int32)
    frames = torch.zeros((3, 8, INPUT_DIM))
    for i, t in enumerate(lens):
        frames[i, :t] = torch.from_numpy(_feats(200 + i, int(t)))
    ref_state = eb.init_state(3)
    ref_rows = [[] for _ in lens]
    for t in range(int(lens.max())):
        act = lens > t
        _, logits = eb.step_frames(ref_state, frames, act, np.full(3, t == 0))
        for b in range(3):
            if act[b]:
                ref_rows[b].append(logits[b].clone())
    state = eb.init_state(3)
    slabs = [t.data_ptr() for t in state.tensors()]
    out = eb.init_out_buf(3, 16)
    state2, out2 = eb.step_chunk(state, frames, lens, np.ones(3, bool),
                                 np.ones(3, bool), out, n_frames=8)
    assert state2 is state and out2 is out
    assert [t.data_ptr() for t in state.tensors()] == slabs
    for b in range(3):
        np.testing.assert_allclose(out[b, :lens[b]].numpy(),
                                   torch.stack(ref_rows[b]).numpy(), atol=1e-6)
    np.testing.assert_array_equal(state.cursor.numpy(), lens)
    for a, b in zip(ref_state.tensors(), state.tensors()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_step_batch_matches_reference_step_batch(model):
    params, jcfg, tparams, tcfg = model
    jc, tc = _configs("dense")
    jb, tb = JBatched(params, jcfg, jc), TBatched(tparams, tcfg, tc,
                                                  device="cpu")
    js, ts = jb.init_state(3), tb.init_state(3)
    rng = np.random.default_rng(5)
    for t in range(5):
        x = rng.standard_normal((3, INPUT_DIM)).astype(np.float32)
        act = np.array([True, t % 2 == 0, True])
        js, jl = jb.step_batch(js, x, act, np.full(3, t == 0))
        ts, tl = tb.step_batch(ts, x, act, np.full(3, t == 0))
        np.testing.assert_allclose(np.asarray(jl)[act], tl.numpy()[act],
                                   atol=1e-5)
    assert tb.measured_sparsity(ts) == pytest.approx(jb.measured_sparsity(js))
    np.testing.assert_allclose(
        np.asarray(jax.device_get(tb.telemetry_totals(ts))),
        np.asarray(jax.device_get(jb.telemetry_totals(js))), rtol=1e-6)


def test_pool_admission_errors(model):
    _, _, tparams, tcfg = model
    eb = TBatched(tparams, tcfg, _configs("scatter")[1], device="cpu")
    pool = SessionPool(eb, 1, max_frames=8, max_buffer_frames=16)
    with pytest.raises(ValueError, match="no frames"):
        pool.admit(StreamRequest(0, 0, np.zeros((0, INPUT_DIM))), 0)
    with pytest.raises(ValueError, match="NaN"):
        pool.admit(StreamRequest(1, 0, np.full((3, INPUT_DIM), np.nan)), 0)
    with pytest.raises(ValueError, match="growth limit"):
        pool.admit(StreamRequest(2, 0, _feats(0, 17)), 0)
    assert pool.admit(StreamRequest(3, 0, _feats(0, 5)), 0)
    assert not pool.admit(StreamRequest(4, 0, _feats(1, 5)), 0)   # full
    with pytest.raises(RuntimeError, match="step_chunk"):
        SessionPool(eb, 1, chunk_frames=4).step(0)


def test_pool_grows_frame_buffers_on_device(model):
    _, _, tparams, tcfg = model
    eb = TBatched(tparams, tcfg, _configs("scatter")[1], device="cpu")
    pool = SessionPool(eb, 2, max_frames=4, chunk_frames=4)
    assert pool.admit(StreamRequest(0, 0, _feats(3, 70)), 0)
    out, now = [], 0
    while pool.n_active or pool.has_pending:
        out += pool.step_chunk(now) if pool.max_chunk_advance() else \
            pool.flush()
        now += 4
    assert pool.n_frame_grows == 1 and out[0].logits.shape == (70, CLASSES)
    np.testing.assert_allclose(
        out[0].logits,
        TEngine(tparams, tcfg, _configs("scatter")[1],
                device="cpu").run_utterance(_feats(3, 70)).numpy(),
        atol=1e-5)
