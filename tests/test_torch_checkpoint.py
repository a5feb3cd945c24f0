"""Port parity, session checkpoints and the watchdog:
repro_torch.serving.checkpoint against itself (bit for bit) and against
the JAX package's snapshots (1e-5), on the CPU.

Model: the reference's robustness-suite model (D=20, H=32, 11 classes, 2
layers, gamma=0.75, m=4, theta=0.05), weights moved across as numpy.
Within the port, a pool killed at a boundary and restored — same
capacity, another capacity (4 -> 8), one session alone, or rebuilt by
the async watchdog — finishes every session with exactly the logits of
the uninterrupted port run (``np.array_equal``).  The port's snapshot
arrays are held to the reference's, taken at the same boundary of the
same schedule, at 1e-5.
"""
import asyncio
from collections import deque

import jax
import numpy as np
import pytest

from repro.core.quantization import QuantConfig as JQuant
from repro.models import lstm_am as jam
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro.serving import checkpoint as jckpt
from repro.serving.scheduler import SessionPool as JPool
from repro_torch.core import QuantConfig
from repro_torch.launch.mesh import emulated_devices
from repro_torch.models import lstm_am as tam
from repro_torch.serving import (
    AsyncSpartusServer,
    BatchedSpartusEngine,
    EngineConfig,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    PoolObservability,
    ServingError,
    StreamRequest,
)
from repro_torch.serving import checkpoint as ckptlib
from repro_torch.serving.scheduler import SessionPool
from repro_torch.training.checkpoint import CheckpointManager, flatten_tree

INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
GAMMA, M, THETA = 0.75, 4, 0.05
LENS = [5, 9, 3, 12, 1, 7]
TOL = 1e-5


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


ECFG = dict(theta=THETA, gamma=GAMMA, m=M, capacity_frac=1.0)


@pytest.fixture(scope="module")
def eb(model):
    return BatchedSpartusEngine(model[2], model[3], EngineConfig(**ECFG),
                                device="cpu")


def _utterance(key, t):
    return np.asarray(
        jax.random.normal(jax.random.key(key), (t, INPUT_DIM)), np.float32)


@pytest.fixture(scope="module")
def feats():
    return [_utterance(300 + i, t) for i, t in enumerate(LENS)]


def _reqs(feats):
    return [StreamRequest(100 + i, 0, f) for i, f in enumerate(feats)]


def _drain(pool, pending, *, now=0, collected=None):
    """Drive a pool to completion, retrying ticks that raise injected
    faults.  Returns {req_id: logits}."""
    out = dict(collected or {})
    pending = deque(pending)
    for _ in range(10_000):
        while pending and pool.n_free and pool.admit(pending[0], now):
            pending.popleft()
        if not (pending or pool.n_active or pool.has_pending):
            break
        try:
            finished, adv = pool.tick(now)
        except InjectedFault:
            continue
        for r in finished:
            out[r.req_id] = r.logits
        now += max(adv, 1)
    else:
        raise AssertionError("pool did not drain")
    for r in pool.flush():
        out[r.req_id] = r.logits
    return out


@pytest.fixture(scope="module")
def uninterrupted(eb, feats):
    """The port pool's own logits, per capacity/chunk: the bit-exact bar
    every restored run is held to."""
    cache = {}

    def get(capacity, chunk):
        if (capacity, chunk) not in cache:
            pool = SessionPool(eb, capacity, max_frames=16,
                               chunk_frames=chunk)
            cache[(capacity, chunk)] = _drain(pool, _reqs(feats))
        return cache[(capacity, chunk)]

    return get


def _warm(pool, pending, n_ticks, now=0, got=None):
    got = dict(got or {})
    for _ in range(n_ticks):
        while pending and pool.n_free and pool.admit(pending[0], now):
            pending.popleft()
        finished, adv = pool.tick(now)
        for r in finished:
            got[r.req_id] = r.logits
        now += max(adv, 1)
    return got, now


@pytest.mark.parametrize("capacity,chunk", [(2, 4), (4, 8), (3, 0)])
def test_checkpoint_restore_roundtrip_bit_identical(
        eb, feats, uninterrupted, tmp_path, capacity, chunk):
    pool = SessionPool(eb, capacity, max_frames=16, chunk_frames=chunk)
    pending = deque(_reqs(feats))
    got, now = _warm(pool, pending, 3)
    for r in pool.checkpoint(str(tmp_path / "ckpt")):
        got[r.req_id] = r.logits
    n_live = pool.n_active
    del pool
    pool2 = SessionPool(eb, capacity, max_frames=16, chunk_frames=chunk)
    pool2.restore(str(tmp_path / "ckpt"))
    assert pool2.n_active == n_live
    got = _drain(pool2, pending, now=now, collected=got)
    ref = uninterrupted(capacity, chunk)
    assert sorted(got) == sorted(ref)
    for rid, logits in ref.items():
        assert np.array_equal(got[rid], logits), rid


def test_capacity_migration_4_to_8_mid_stream(eb, feats, uninterrupted):
    """Capacity is placement, not semantics: streams snapshotted out of
    a 4-slot pool mid-utterance continue bit-identically in an 8-slot
    pool (frames still arriving after the move)."""
    pool = SessionPool(eb, 4, max_frames=8, chunk_frames=4)
    sent = {}
    for i in range(4):
        assert pool.admit_stream(100 + i, 0, feats=feats[i][:2])
        sent[100 + i] = 2
    got = {r.req_id: r.logits for r in pool.tick(0)[0]}
    for i in range(4):
        pool.append_frames(100 + i, feats[i][2:4])
        sent[100 + i] = min(4, LENS[i])
    ckpt = pool.snapshot()            # staged appends ride the snapshot
    big = SessionPool(eb, 8, max_frames=8, chunk_frames=4)
    ckptlib.restore_into(big, ckpt)
    assert big.n_active == 4
    for i in range(4):
        big.append_frames(100 + i, feats[i][sent[100 + i]:])
        big.finish_stream(100 + i)
    got.update(_drain(big, [], now=4))
    ref = uninterrupted(4, 4)
    for i in range(4):
        assert np.array_equal(got[100 + i], ref[100 + i]), i


def test_single_session_snapshot_migrates(eb, feats, uninterrupted):
    pool = SessionPool(eb, 4, max_frames=16, chunk_frames=4)
    for i in range(4):
        assert pool.admit(StreamRequest(100 + i, 0, feats[i]), 0)
    got = {r.req_id: r.logits for r in pool.tick(0)[0]}
    snap = pool.snapshot_session(101)
    assert snap.req_id == 101
    other = SessionPool(eb, 2, max_frames=16, chunk_frames=4)
    assert other.admit(StreamRequest(104, 0, feats[4]), 0)
    assert other.restore_session(snap)
    got.update(_drain(other, [], now=4))
    ref = uninterrupted(4, 4)
    assert np.array_equal(got[101], ref[101])
    assert np.array_equal(got[104], ref[104])


@pytest.mark.parametrize("src_dev,dst_dev,dst_cap", [
    (None, 4, 4), (4, None, 4), (4, 2, 4), (2, 4, 8)])
def test_restore_across_shard_counts(eb, feats, uninterrupted, tmp_path,
                                     src_dev, dst_dev, dst_cap):
    """The migration primitive across shard counts (logical shards on the
    host): a checkpoint written at one shard count restores at another,
    at the same capacity or a migrated one.  Every array the restored
    pool holds equals the file bit for bit.  Each shard's chunk is the
    unsharded chunk at the shard's batch, so every session finishes with
    exactly the uninterrupted pool's logits while every shard holds >= 2
    slots; at 1 slot a shard's fp32 GEMMs take the host BLAS's
    matrix-vector path, whose sums differ in the last bits (about 1e-7
    here), and the bar is the reference's own for this test, 1e-5."""
    with emulated_devices(4):
        pool = SessionPool(eb, 4, max_frames=16, chunk_frames=4,
                           n_devices=src_dev)
        dst = SessionPool(eb, dst_cap, max_frames=16, chunk_frames=4,
                          n_devices=dst_dev)
    assert (pool.n_shards, dst.n_shards) == (src_dev or 1, dst_dev or 1)
    pending = deque(_reqs(feats[:4]))
    while pending and pool.n_free and pool.admit(pending[0], 0):
        pending.popleft()
    got = {r.req_id: r.logits for r in pool.tick(0)[0]}
    for r in pool.checkpoint(str(tmp_path / "mig")):
        got[r.req_id] = r.logits
    dst.restore(str(tmp_path / "mig"))
    saved = {s.req_id: s for s in
             ckptlib.load_checkpoint(str(tmp_path / "mig")).sessions}
    restored = ckptlib.snapshot_pool(dst).sessions
    assert sorted(s.req_id for s in restored) == sorted(saved)
    for snap in restored:
        ref_snap = saved[snap.req_id]
        assert snap.meta == ref_snap.meta
        for key, arr in ref_snap.arrays.items():
            assert np.array_equal(snap.arrays[key], arr), key
    if dst.n_shards > 1:       # admission spread the sessions evenly
        assert max(dst.shard_loads()) - min(dst.shard_loads()) <= 1
    got = _drain(dst, [], now=4, collected=got)
    ref = uninterrupted(4, 4)
    bar = 0.0 if min(4 // pool.n_shards, dst_cap // dst.n_shards) > 1 else TOL
    for i in range(4):
        assert np.abs(got[100 + i] - ref[100 + i]).max() <= bar, i


@pytest.mark.parametrize("chunk", [4, 0])
def test_snapshot_arrays_match_reference(model, feats, chunk):
    """The same schedule through both packages, snapshotted at the same
    boundary: every session's metadata is equal and every array within
    1e-5 (frames exactly)."""
    params, jcfg, _, _ = model
    jeb = JBatched(params, jcfg, JConfig(**ECFG))
    teb = BatchedSpartusEngine(model[2], model[3], EngineConfig(**ECFG),
                               device="cpu")
    snaps = []
    for eng, pool_cls, lib in ((jeb, JPool, jckpt),
                               (teb, SessionPool, ckptlib)):
        pool = pool_cls(eng, 4, max_frames=16, chunk_frames=chunk)
        pending = deque(_reqs(feats[:3]))
        _warm(pool, pending, 2)
        assert pool.admit_stream(900, 9, feats=feats[5][:3])
        pool.append_frames(900, feats[5][3:5])    # staged, not uploaded
        snaps.append(lib.snapshot_pool(pool))
    jsnap, tsnap = snaps
    assert tsnap.meta == jsnap.meta
    assert [s.meta for s in tsnap.sessions] == [s.meta for s in
                                                jsnap.sessions]
    for js, ts in zip(jsnap.sessions, tsnap.sessions):
        assert sorted(ts.arrays) == sorted(js.arrays)
        for key, arr in js.arrays.items():
            assert ts.arrays[key].shape == arr.shape, key
            assert ts.arrays[key].dtype == arr.dtype, key
            np.testing.assert_allclose(ts.arrays[key], arr, atol=TOL,
                                       err_msg=key)
        np.testing.assert_array_equal(ts.arrays["frames"],
                                      js.arrays["frames"])


def test_fingerprint_and_restore_guards(model, eb, feats, tmp_path):
    params, jcfg, tparams, tcfg = model
    pool = SessionPool(eb, 2, max_frames=16, chunk_frames=4)
    assert pool.admit(StreamRequest(100, 0, feats[0]), 0)
    ckpt = pool.snapshot()
    fp = ckptlib.engine_fingerprint(eb)
    assert ckpt.meta["engine"] == fp
    assert fp == jckpt.engine_fingerprint(JBatched(params, jcfg,
                                                   JConfig(**ECFG)))
    with pytest.raises(ValueError, match="already in the pool"):
        pool.restore_session(pool.snapshot_session(100))
    with pytest.raises(ValueError, match="empty pool"):
        ckptlib.restore_into(pool, ckpt)
    other = BatchedSpartusEngine(tparams, tcfg,
                                 EngineConfig(**{**ECFG, "theta": 0.2}),
                                 device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        ckptlib.restore_into(SessionPool(other, 2, chunk_frames=4), ckpt)
    with pytest.raises(FileNotFoundError):
        ckptlib.load_checkpoint(str(tmp_path / "nope"))
    with pytest.raises(KeyError):
        ckptlib.snapshot_session(pool, 555)


def test_quant_format_refusal(model, eb, feats):
    """A quantized pool never restores an fp32 pool's sessions, nor the
    reverse: the recurrent state lives on another grid."""
    params, jcfg, tparams, tcfg = model
    q = BatchedSpartusEngine(tparams, tcfg,
                             EngineConfig(**ECFG, quant=QuantConfig()),
                             device="cpu")
    fq = ckptlib.engine_fingerprint(q)
    assert fq["quant"] == [8, 16, 8]
    assert fq == jckpt.engine_fingerprint(
        JBatched(params, jcfg, JConfig(**ECFG, quant=JQuant())))
    fp_pool = SessionPool(eb, 2, max_frames=16, chunk_frames=4)
    assert fp_pool.admit(StreamRequest(1, 0, feats[1]), 0)
    q_pool = SessionPool(q, 2, max_frames=16, chunk_frames=4)
    assert q_pool.admit(StreamRequest(2, 0, feats[2]), 0)
    with pytest.raises(ValueError, match="fingerprint"):
        ckptlib.restore_into(SessionPool(q, 2, chunk_frames=4),
                             fp_pool.snapshot())
    with pytest.raises(ValueError, match="fingerprint"):
        ckptlib.restore_into(SessionPool(eb, 2, chunk_frames=4),
                             q_pool.snapshot())


def test_save_load_roundtrip(eb, feats, tmp_path):
    pool = SessionPool(eb, 3, max_frames=16, chunk_frames=4)
    pending = deque(_reqs(feats))
    _warm(pool, pending, 1)
    path = str(tmp_path / "rt")
    pool.checkpoint(path)
    mem = pool.snapshot()
    disk = ckptlib.load_checkpoint(path)
    assert {k: v for k, v in disk.meta.items() if k != "step"} == mem.meta
    assert disk.meta["step"] == pool.n_dispatches
    for a, b in zip(mem.sessions, disk.sessions):
        assert a.meta == b.meta and sorted(a.arrays) == sorted(b.arrays)
        for key in a.arrays:
            assert np.array_equal(a.arrays[key], b.arrays[key]), key
    # retention: the newest keep_last committed steps survive
    mgr = CheckpointManager(path, keep_last=2)
    for step in (10, 11, 12):
        mgr.save(step, {"x": np.full(3, step, np.float32)})
    assert mgr.all_steps() == [11, 12]
    arrays, meta = mgr.restore_arrays(12)
    assert meta["step"] == 12 and arrays["x"][0] == 12


def test_flatten_tree_keys_and_host_copies():
    import torch

    tree = {"a": torch.arange(3.0), "b": [np.ones(2), (np.zeros(1),)]}
    flat = flatten_tree(tree)
    assert sorted(flat) == ["a", "b/0", "b/1/0"]
    assert all(isinstance(v, np.ndarray) for v in flat.values())
    np.testing.assert_array_equal(flat["a"], [0.0, 1.0, 2.0])
    assert flatten_tree({"x/y": flat["a"]}).keys() == {"x/y"}


# -- the pool's fault sites and the async watchdog ---------------------------


@pytest.mark.parametrize("site,ats", [("dispatch", (1, 3)),
                                      ("admission_upload", (0, 2))])
def test_pool_fault_retry_bit_identical(eb, feats, uninterrupted, site, ats):
    inj = FaultInjector(FaultPlan(
        events=tuple(FaultEvent(site, at) for at in ats)))
    pool = SessionPool(eb, 3, max_frames=16, chunk_frames=4, faults=inj)
    got = _drain(pool, _reqs(feats))
    assert len(inj.fired) == len(ats)
    ref = uninterrupted(3, 4)
    for rid, logits in ref.items():
        assert np.array_equal(got[rid], logits), rid


def _async_submit_all(eb, feats, **kw):
    async def run():
        async with AsyncSpartusServer(eb, 4, chunk_frames=4, max_frames=16,
                                      offload_ticks=False, **kw) as srv:
            res = await asyncio.gather(*[srv.submit(f) for f in feats])
            return res, srv.n_recoveries

    return asyncio.run(run())


@pytest.mark.parametrize("ats", [(1,), (1, 3)])
def test_watchdog_recovers_bit_identical(eb, feats, ats):
    clean, n0 = _async_submit_all(eb, feats)
    inj = FaultInjector(FaultPlan(
        events=tuple(FaultEvent("dispatch", at) for at in ats)))
    obs = PoolObservability()
    res, n_rec = _async_submit_all(eb, feats, watchdog=True, faults=inj,
                                   observability=obs)
    assert n0 == 0 and n_rec == len(ats)
    for a, b in zip(clean, res):
        assert np.array_equal(a.logits, b.logits), a.req_id
    assert obs.c_recoveries.value == len(ats)
    assert obs.c_salvaged.value > 0 and obs.c_lost.value == 0


def test_watchdog_recovers_a_sharded_pool_bit_identical(eb, feats):
    """The reference's ``((2,), 4)`` case: the watchdog rebuilds a pool of
    4 logical shards from the same kwargs after a dispatch crash, and
    every session finishes with exactly the fault-free logits of the
    same sharded pool, and within 1e-5 of the unsharded pool's (one
    slot a shard: see test_restore_across_shard_counts)."""
    unsharded, _ = _async_submit_all(eb, feats)
    inj = FaultInjector(FaultPlan(events=(FaultEvent("dispatch", 2),)))
    obs = PoolObservability()
    with emulated_devices(4):
        clean, _ = _async_submit_all(eb, feats, n_devices=4)
        res, n_rec = _async_submit_all(eb, feats, watchdog=True, faults=inj,
                                       observability=obs, n_devices=4)
    assert n_rec == 1 and obs.c_recoveries.value == 1
    for a, b, u in zip(clean, res, unsharded):
        assert np.array_equal(a.logits, b.logits), a.req_id
        assert np.abs(b.logits - u.logits).max() <= TOL, a.req_id
    assert obs.c_salvaged.value > 0 and obs.c_lost.value == 0


def test_watchdog_poison_fails_only_unsalvageable(eb, feats):
    clean, _ = _async_submit_all(eb, feats)
    inj = FaultInjector(FaultPlan(
        events=(FaultEvent("dispatch", 1, payload="poison"),)))

    async def run():
        async with AsyncSpartusServer(
                eb, 4, chunk_frames=4, max_frames=16, offload_ticks=False,
                watchdog=True, faults=inj) as srv:
            handles = [await srv.stream(feats[i]) for i in range(4)]
            for h in handles:
                h.close()
            ok = lost = 0
            for h in handles:
                try:
                    r = await h.result()
                    assert np.array_equal(r.logits, clean[r.req_id].logits)
                    ok += 1
                except ServingError as e:
                    assert e.retriable and e.code == "retriable_internal"
                    lost += 1
            assert srv.n_recoveries == 1 and lost >= 1
            r = await srv.submit(feats[5])
            assert np.array_equal(r.logits, clean[5].logits)

    asyncio.run(run())
