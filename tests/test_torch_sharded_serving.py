"""Slot-dimension data parallelism for the port's serving pool
(`SessionPool(n_devices=N)`, ``repro_torch/serving/sharding.py``) on the
CPU, through the tests of the reference's ``tests/test_sharded_serving.py``.

The reference emulates devices with
``--xla_force_host_platform_device_count``; the port runs N logical
shards on the one host device (``launch.mesh.emulated_devices``), so the
multi-device grid runs in every tier-1 run, with no subprocess leg.

Model: the reference's (D=20, H=32, 11 classes, 2 layers, gamma=0.75,
m=4, theta=0.05) and its ragged ``LENS``, weights moved across as numpy.
Bars: the port's sharded logits are held to the reference's batch-1
``SpartusEngine`` at 1e-5, and to the port's unsharded pool bit for bit
wherever every shard holds >= 2 slots.  A shard of 1 slot runs its fp32
GEMMs (the head's ``h @ w.T``) at M=1, where the host BLAS takes a
matrix-vector path whose sums differ in the last bits from the M >= 2
path: there the measured gap to the unsharded pool is about 1e-7, held
at 1e-5.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lstm_am as jam
from repro.serving import EngineConfig as JConfig
from repro.serving import SpartusEngine as JEngine
from repro_torch.core import QuantConfig
from repro_torch.distributed.sharding import P, slot_spec
from repro_torch.launch.mesh import compat_make_mesh, emulated_devices
from repro_torch.models import lstm_am as tam
from repro_torch.serving import (
    AsyncSpartusServer,
    BatchedSpartusEngine,
    EngineConfig,
    StreamRequest,
    serve_requests,
)
from repro_torch.serving import sharding as shardlib
from repro_torch.serving.scheduler import SessionPool

INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
GAMMA, M, THETA = 0.75, 4, 0.05
LENS = [5, 9, 3, 12, 1, 7, 8, 2]
TOL = 1e-5
ECFG = dict(theta=THETA, gamma=GAMMA, m=M, capacity_frac=1.0)


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


def _engine(model, route="auto", quant=False):
    return BatchedSpartusEngine(
        model[2], model[3],
        EngineConfig(**ECFG, spmv_path=route,
                     quant=QuantConfig() if quant else None),
        device="cpu")


@pytest.fixture(scope="module")
def eb(model):
    return _engine(model)


def _utterance(key, t):
    return np.asarray(
        jax.random.normal(jax.random.key(key), (t, INPUT_DIM)), np.float32)


def _oracle(model, feats, quant=False):
    """The reference's batch-1 engine on the same params."""
    from repro.core.quantization import QuantConfig as JQuant

    e1 = JEngine(model[0], model[1],
                 JConfig(**ECFG, quant=JQuant() if quant else None))
    return [np.asarray(e1.run_utterance(jnp.asarray(f))) for f in feats]


@pytest.fixture(scope="module")
def workload(model):
    feats = [_utterance(500 + i, t) for i, t in enumerate(LENS)]
    reqs = [StreamRequest(i, 2 * i, feats[i]) for i in range(len(LENS))]
    return feats, _oracle(model, feats), reqs


def _bar(capacity, n_shards):
    """0 (bit for bit) when every shard holds >= 2 slots, else 1e-5."""
    return 0.0 if capacity // n_shards > 1 else TOL


# -- spec logic (no devices) --------------------------------------------------

MESH4 = compat_make_mesh((4,), ("data",), "meta")
MESH1 = compat_make_mesh((1,), ("data",), "meta")


def test_slot_spec_divisible_shards_dim():
    assert slot_spec((8, 3), MESH4) == P("data", None)
    assert slot_spec((8,), MESH4) == P("data")
    assert slot_spec((2, 8, 5), MESH4, dim=1) == P(None, "data", None)


def test_slot_spec_never_invalid():
    # non-divisible slot dim, or a trivial mesh: replicate, never error
    assert slot_spec((6, 3), MESH4) == P(None, None)
    assert slot_spec((8, 3), MESH1) == P(None, None)
    assert slot_spec((2, 6, 5), MESH4, dim=1) == P(None, None, None)


def test_shard_bounds_and_counts():
    assert shardlib.shard_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert shardlib.shard_bounds(8, 1) == [(0, 8)]
    assert shardlib.n_pool_shards(MESH4, 8) == 4
    assert shardlib.n_pool_shards(MESH4, 6) == 1   # fallback: one shard
    assert shardlib.n_pool_shards(MESH1, 8) == 1


def test_pool_state_splits_and_joins_back(eb):
    """`shard_pool_state` cuts every slab at its slot dim (telemetry at
    dim 1) into tensors of their own; `join_pool_state` restores the
    whole state; a non-divisible capacity is one shard."""
    state = eb.init_state(8)
    for t in state.tensors():
        t.copy_(torch.randn(t.shape).to(t.dtype))
    with emulated_devices(4):
        mesh = shardlib.make_pool_mesh(4, "cpu")
    parts = shardlib.shard_pool_state(state, mesh)
    assert len(parts) == 4
    assert parts[1].layers[0].s_hat.shape[0] == 2
    assert parts[1].telemetry.steps.shape == (2, 2)
    assert all(t.is_contiguous() for p in parts for t in p.tensors())
    ptrs = [t.untyped_storage().data_ptr() for p in parts
            for t in p.tensors()]
    assert len(set(ptrs)) == len(ptrs)
    joined = shardlib.join_pool_state(parts)
    for a, b in zip(joined.tensors(), state.tensors()):
        assert torch.equal(a, b)
    assert len(shardlib.shard_pool_state(eb.init_state(6), mesh)) == 1


# -- one device ----------------------------------------------------------------


def test_sharded_pool_n_devices_1_parity(eb, workload):
    """n_devices=1 builds the mesh and placement path end to end (one
    shard) and is bit for bit the unsharded pool."""
    feats, refs, reqs = workload
    for chunk in (0, 4):
        base, _ = serve_requests(eb, reqs, capacity=4, chunk_frames=chunk)
        res, stats = serve_requests(eb, reqs, capacity=4, chunk_frames=chunk,
                                    n_devices=1)
        for r in res:
            np.testing.assert_allclose(r.logits, refs[r.req_id], atol=TOL)
            assert np.array_equal(r.logits, base[r.req_id].logits)
        assert stats.sparsity      # telemetry survived the mesh path


def test_n_devices_overcommit_raises():
    with pytest.raises(ValueError, match="device"):
        shardlib.make_pool_mesh(1024, "cpu")
    with pytest.raises(ValueError, match=">= 1"):
        shardlib.make_pool_mesh(0, "cpu")


# -- the multi-device grid, on logical host shards ----------------------------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_parity_grid(eb, workload, n_dev):
    """Sharded pools reproduce the reference's batch-1 logits at 1e-5
    over (capacity, chunk_frames) with ragged lengths and staggered
    arrivals, including a capacity NOT divisible by the shard count
    (one shard), and the port's unsharded pool bit for bit wherever every
    shard holds >= 2 slots."""
    feats, refs, reqs = workload
    for capacity, chunk in ((4, 0), (4, 4), (8, 8), (6, 4)):
        base, _ = serve_requests(eb, reqs, capacity=capacity,
                                 chunk_frames=chunk)
        with emulated_devices(n_dev):
            pool = SessionPool(eb, capacity, n_devices=n_dev)
            res, _ = serve_requests(eb, reqs, capacity=capacity,
                                    chunk_frames=chunk, n_devices=n_dev)
        n_shards = n_dev if capacity % n_dev == 0 else 1
        assert pool.n_shards == n_shards
        assert [r.req_id for r in res] == list(range(len(LENS)))
        for r in res:
            what = f"n_dev={n_dev} cap={capacity} chunk={chunk} req={r.req_id}"
            np.testing.assert_allclose(r.logits, refs[r.req_id], atol=TOL,
                                       err_msg=what)
            gap = np.abs(r.logits - base[r.req_id].logits).max()
            assert gap <= _bar(capacity, n_shards), (what, gap)


@pytest.mark.parametrize("route,quant", [("scatter", False),
                                         ("scatter", True), ("auto", True)])
def test_sharded_routes_parity(model, workload, route, quant):
    """The scatter route and the int8 packs (the reference's
    ``test_quant_sharded_pool_parity``) over 4 shards of 2 slots: the
    reference's batch-1 logits at 1e-5, the port's unsharded pool bit
    for bit."""
    feats, refs, reqs = workload
    engine = _engine(model, route, quant)
    refs = _oracle(model, feats, quant=True) if quant else refs
    base, _ = serve_requests(engine, reqs, capacity=8, chunk_frames=4)
    with emulated_devices(4):
        res, stats = serve_requests(engine, reqs, capacity=8, chunk_frames=4,
                                    n_devices=4)
    for r in res:
        np.testing.assert_allclose(r.logits, refs[r.req_id], atol=TOL)
        assert np.array_equal(r.logits, base[r.req_id].logits), r.req_id
    assert stats.sparsity == serve_requests(
        engine, reqs, capacity=8, chunk_frames=4)[1].sparsity


def _pool(eb, capacity, n_devices):
    with emulated_devices(n_devices):
        return SessionPool(eb, capacity=capacity, max_frames=16,
                           chunk_frames=4, n_devices=n_devices)


def test_least_loaded_shard_admission_and_skew(eb):
    """Admissions spread across shards (least-loaded placement), and a
    deliberately skewed occupancy re-balances as new sessions arrive."""
    pool = _pool(eb, 8, 4)
    assert pool.n_shards == 4
    for i in range(4):
        assert pool.admit(StreamRequest(i, 0, _utterance(600 + i, 8)), 0)
    assert pool.shard_loads() == [1, 1, 1, 1]      # one per shard
    # skew: free shards 1..3 by cancelling their sessions, keep shard 0
    for i in range(1, 4):
        pool.cancel(i)
    pool.step_chunk(now=0)
    assert pool.shard_loads() == [1, 0, 0, 0]
    # the next admissions go to the empty shards, not next to slot 0:
    for i in range(10, 13):
        assert pool.admit(StreamRequest(i, 1, _utterance(610 + i, 8)), 1)
    assert pool.shard_loads() == [1, 1, 1, 1]
    pool.drain(now=2)


def test_sharded_midchunk_retirement_on_nonzero_shard(model, eb):
    """A session living on a non-zero shard retires mid-chunk; its slot
    is reused; logits parity holds throughout."""
    pool = _pool(eb, 4, 4)
    lens = [8, 3, 8, 8]                  # slot 1 (shard 1) dies mid-chunk
    feats = [_utterance(620 + i, t) for i, t in enumerate(lens)]
    for i in range(4):
        assert pool.admit(StreamRequest(i, 0, feats[i]), 0)
    assert pool.shard_loads() == [1, 1, 1, 1]
    results = []
    results.extend(pool.step_chunk(0))     # session 1 retires mid-chunk
    assert pool.shard_loads() == [1, 0, 1, 1]
    # the freed shard-1 slot is the least-loaded choice for the next
    # admission (slot reuse while its old snapshot is still in flight):
    assert pool.admit(StreamRequest(9, 4, _utterance(630, 5)), 4)
    assert pool.shard_loads() == [1, 1, 1, 1]
    now = 4
    for _ in range(3):
        results.extend(pool.step_chunk(now))
        now += 4
    results.extend(pool.flush())
    got = {r.req_id: r.logits for r in results}
    refs = _oracle(model, feats + [_utterance(630, 5)])
    for i in range(4):
        np.testing.assert_allclose(got[i], refs[i], atol=TOL)
    np.testing.assert_allclose(got[9], refs[4], atol=TOL)


def test_sharded_async_server_parity(eb, workload):
    """The asyncio front-end over a 4-shard pool streams the oracle
    logits (admission-while-running exercises per-shard placement and
    per-shard retirement fetches)."""
    feats, refs, _ = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=4, chunk_frames=4,
                                      max_frames=16, offload_ticks=False,
                                      n_devices=4) as srv:
            assert srv.pool.n_shards == 4
            return await asyncio.gather(
                *[srv.submit(feats[i], want_partials=True)
                  for i in range(len(feats))])

    with emulated_devices(4):
        results = asyncio.run(run())
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.logits, refs[i], atol=TOL)


def test_sharded_serving_4dev_no_cross_shard_traffic(eb, workload):
    """The reference's subprocess leg, in process: 4 shards match the
    batch-1 oracle at 1e-5 (with the non-divisible fallback), and the
    sharded chunk (``step_chunk/sharded-4dev``) holds every clause of its
    contract (no host transfer, no collective), no op touches two
    shards' tensors and each shard runs the unsharded chunk's ops."""
    from repro_torch.analysis import cases, contracts

    feats, refs, reqs = workload
    max_err = 0.0
    for cap in (8, 6):
        with emulated_devices(4):
            res, _ = serve_requests(eb, reqs, capacity=cap, chunk_frames=4,
                                    n_devices=4)
        max_err = max(max_err, max(
            float(np.abs(r.logits - refs[r.req_id]).max()) for r in res))
    assert max_err <= TOL
    case = {c.name: c for c in cases.build_cases(device="cpu")}[
        "step_chunk/sharded-4dev"]
    report = contracts.check_case(case)
    assert report.ok, [str(v) for v in report.violations]
