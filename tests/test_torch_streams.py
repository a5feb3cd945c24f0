"""Port parity, SessionPool stream API: incremental streams, partials,
peek/pause/resume, dispatch-free retirement, append growth and the
double-buffered retirement fetch — the port against the JAX package on
the same drip schedule.

Model: D=20, H=128, 2 layers, 11 classes, CBTD gamma=0.9375 at m=64
(S=8 PEs of BLEN=1, so "auto" routes to the CBCSC scatter kernel's plain
version), theta=0.05; every case also runs on the dense-mirror route.
Tolerances: port vs reference 1e-5 (same math, another summation order);
port vs port bit for bit (concatenated partials vs the final logits,
peeked rows vs the final logits).
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.models import lstm_am as jam
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro.serving.scheduler import SessionPool as JPool
from repro_torch._device import HostCopy
from repro_torch.launch.mesh import emulated_devices
from repro_torch.models import lstm_am as tam
from repro_torch.serving import BatchedSpartusEngine as TBatched
from repro_torch.serving import EngineConfig as TConfig
from repro_torch.serving import SpartusEngine as TEngine
from repro_torch.serving import serve_requests as tserve
from repro_torch.serving.scheduler import SessionPool as TPool
from repro_torch.serving.scheduler import StreamRequest

INPUT_DIM, HIDDEN, CLASSES = 20, 128, 11
GAMMA, M, THETA = 0.9375, 64, 0.05
ROUTES = ["auto", "dense"]
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    tcfg = tam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    params = jam.cbtd_prune_stacks(jam.init_params(jax.random.key(3), jcfg),
                                   gamma=GAMMA, m=M)
    tparams = tam.params_from_numpy(jax.device_get(params), device="cpu")
    return params, jcfg, tparams, tcfg


def _engines(model, route):
    params, jcfg, tparams, tcfg = model
    kw = dict(theta=THETA, gamma=GAMMA, m=M, capacity_frac=0.5,
              spmv_path=route)
    return (JBatched(params, jcfg, JConfig(**kw)),
            TBatched(tparams, tcfg, TConfig(**kw), device="cpu"))


def _feats(seed, t):
    return np.random.default_rng(seed).standard_normal(
        (t, INPUT_DIM)).astype(np.float32)


LENS = [23, 9, 40, 1, 17, 31]


def _schedule(seed=0):
    """A seeded drip schedule: per tick, a list of ops
    ("admit", rid, n) / ("append", rid, n) / ("finish", rid) /
    ("pause", rid) / ("resume", rid), feeding LENS with gaps."""
    rng = np.random.default_rng(seed)
    sent = [0] * len(LENS)
    admitted = [False] * len(LENS)
    finished = [False] * len(LENS)
    ticks = []
    t = 0
    while not all(finished):
        ops = []
        for rid, n_total in enumerate(LENS):
            if finished[rid] or t < 2 * rid:
                continue
            if not admitted[rid]:
                n = int(min(rng.integers(0, 4), n_total))
                ops.append(("admit", rid, n))
                admitted[rid], sent[rid] = True, n
            elif rng.random() < 0.6 and sent[rid] < n_total:
                n = int(min(rng.integers(1, 7), n_total - sent[rid]))
                ops.append(("append", rid, n))
                sent[rid] += n
            if sent[rid] == n_total and rng.random() < 0.5:
                ops.append(("finish", rid))
                finished[rid] = True
        if t == 4:
            ops.append(("pause", 2))
        if t == 9:
            ops.append(("resume", 2))
        ticks.append(ops)
        t += 1
    return ticks


def _drive(pool, feats, ticks, peek_at=None):
    """Run the schedule through a pool (either package): a request that
    finds the pool full keeps its ops in a backlog until a slot frees.
    Returns (results by rid, partial rows by (rid, t0), peeked rows)."""
    sent = [0] * len(feats)
    backlog = {}
    results, partials, peeked = {}, {}, None
    now = 0

    def apply(op):
        kind, rid = op[0], op[1]
        if kind == "admit":
            if not pool.admit_stream(rid, now, feats=feats[rid][:op[2]]):
                return False
            sent[rid] = op[2]
        elif kind == "append":
            pool.append_frames(rid, feats[rid][sent[rid]:sent[rid] + op[2]])
            sent[rid] += op[2]
        elif kind == "finish":
            pool.finish_stream(rid)
        elif kind == "pause":
            pool.pause_partials(rid)
        else:
            pool.resume_partials(rid)
        return True

    for step, ops in enumerate(ticks + [[]] * 60):
        for rid in sorted(backlog):
            queued = backlog.pop(rid)
            if not apply(queued[0]):
                backlog[rid] = queued
                continue
            for op in queued[1:]:
                apply(op)
        for op in ops:
            if op[1] in backlog or not (op[1] in backlog or apply(op)):
                backlog.setdefault(op[1], []).append(op)
        if step == peek_at and 2 in pool._by_req:
            peeked = np.asarray(pool.peek_rows(2, 1))
        finished, adv = pool.tick(now)
        now += max(adv, 1)
        for r in finished:
            results[r.req_id] = np.asarray(r.logits)
        for p in pool.take_partials():
            partials[(p.req_id, p.t0)] = np.asarray(p.rows)
        if len(results) == len(feats) and not pool.has_pending:
            break
    return results, partials, peeked


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("capacity,chunk", [(3, 4), (6, 8), (2, 1)])
def test_drip_schedule_matches_reference(model, route, capacity, chunk):
    jeb, teb = _engines(model, route)
    feats = [_feats(40 + i, t) for i, t in enumerate(LENS)]
    ticks = _schedule(seed=capacity * 10 + chunk)
    kw = dict(max_frames=8, chunk_frames=chunk, stream_partials=True)
    jres, jpart, jpeek = _drive(JPool(jeb, capacity, **kw), feats, ticks, 12)
    tres, tpart, tpeek = _drive(TPool(teb, capacity, **kw), feats, ticks, 12)
    assert sorted(tres) == sorted(jres) == list(range(len(LENS)))
    assert sorted(tpart) == sorted(jpart)          # same (rid, t0) blocks
    for key, rows in jpart.items():
        np.testing.assert_allclose(tpart[key], rows, atol=TOL)
    e1 = TEngine(model[2], model[3], teb.cfg, device="cpu")
    for rid, logits in tres.items():
        assert logits.shape == (LENS[rid], CLASSES)
        np.testing.assert_allclose(logits, jres[rid], atol=TOL)
        np.testing.assert_allclose(
            logits, e1.run_utterance(feats[rid]).numpy(), atol=TOL)
        blocks = sorted((t0, r) for (i, t0), r in tpart.items() if i == rid)
        if rid != 2 and blocks:
            # every frame streamed once, in order: the partials ARE the
            # result
            np.testing.assert_array_equal(
                np.concatenate([r for _, r in blocks]), logits)
    # request 2 was paused for five ticks: its partials skip that range,
    # which the peek (or the final result) covers, bit for bit
    covered = sum(r.shape[0] for (i, _), r in tpart.items() if i == 2)
    if chunk > 1:
        assert covered < LENS[2]
        assert tpeek is not None and tpeek.shape[0] > 0
        np.testing.assert_array_equal(tpeek, tres[2][1:1 + tpeek.shape[0]])
        np.testing.assert_allclose(tpeek, jpeek, atol=TOL)


@pytest.mark.parametrize("route", ROUTES)
def test_zero_frame_stream_retires_without_dispatch(model, route):
    jeb, teb = _engines(model, route)
    out = []
    for eng, pool_cls in ((jeb, JPool), (teb, TPool)):
        pool = pool_cls(eng, 2, max_frames=8, chunk_frames=4,
                        stream_partials=True)
        assert pool.admit_stream(7, 0)
        pool.finish_stream(7)
        assert pool.has_retirable
        res, adv = pool.tick(0)
        assert adv == 0 and pool.n_active == 0
        res += pool.flush()
        assert [r.req_id for r in res] == [7]
        out.append(np.asarray(res[0].logits))
        assert pool.n_dispatches == 0
    assert out[0].shape == out[1].shape == (0, CLASSES)


@pytest.mark.parametrize("route", ROUTES)
def test_append_grows_buffers_on_device(model, route):
    """Appends past the frame bucket grow the device buffers once per
    bucket; no frame is clamped into an earlier position."""
    jeb, teb = _engines(model, route)
    feats = _feats(9, 150)
    logits = []
    for eng, pool_cls in ((jeb, JPool), (teb, TPool)):
        pool = pool_cls(eng, 2, max_frames=4, chunk_frames=8)
        assert pool.admit_stream(0, 0, feats=feats[:30])
        pool.tick(0)
        pool.append_frames(0, feats[30:100])      # 64 -> 128
        pool.tick(8)
        pool.append_frames(0, feats[100:])        # 128 -> 256
        pool.finish_stream(0)
        res, now = [], 16
        while pool.n_active or pool.has_pending:
            res += pool.tick(now)[0]
            now += 8
        # the port's wave writes exact offsets, so it grows to the bucket
        # of its last frame (100 -> 128, 150 -> 256); the reference pads
        # each wave to a pow2 block first (30 + 128 -> 256 at once)
        assert pool.n_frame_grows == (2 if pool_cls is TPool else 1)
        logits.append(np.asarray(res[0].logits))
    np.testing.assert_allclose(logits[1], logits[0], atol=TOL)
    np.testing.assert_allclose(
        logits[1], TEngine(model[2], model[3], teb.cfg,
                           device="cpu").run_utterance(feats).numpy(),
        atol=TOL)


def test_max_buffer_frames_refusal(model):
    _, teb = _engines(model, "auto")
    pool = TPool(teb, 2, max_frames=8, chunk_frames=4, max_buffer_frames=16)
    with pytest.raises(ValueError, match="growth limit"):
        pool.admit_stream(0, 0, feats=_feats(0, 17))
    assert pool.admit_stream(1, 0, feats=_feats(1, 10))
    with pytest.raises(ValueError, match="growth limit"):
        pool.append_frames(1, _feats(2, 7))
    pool.append_frames(1, _feats(3, 6))           # exactly 16: accepted
    with pytest.raises(ValueError, match="feature dim|must be"):
        pool.append_frames(1, np.zeros((2, 5), np.float32))
    pool.finish_stream(1)
    with pytest.raises(ValueError, match="already finished"):
        pool.append_frames(1, _feats(4, 1))
    with pytest.raises(KeyError):
        pool.append_frames(99, _feats(4, 1))
    with pytest.raises(RuntimeError, match="chunked"):
        TPool(teb, 1).peek_rows(0)


def test_multi_gpu_sharding_raises(model):
    """More shards than visible devices raises the overcommit error;
    with two (emulated) devices the pool shards and serves the
    unsharded pool's logits bit for bit."""
    _, teb = _engines(model, "auto")
    reqs = [StreamRequest(i, 0, _feats(i, 3 + 2 * i)) for i in range(3)]
    with pytest.raises(ValueError, match="visible"):
        TPool(teb, 4, chunk_frames=4, n_devices=2)
    with pytest.raises(ValueError, match="visible"):
        tserve(teb, reqs, 2, n_devices=2)
    base, _ = tserve(teb, reqs, 4, chunk_frames=4)
    res, _ = tserve(teb, reqs, 4, chunk_frames=4, n_devices=1)
    with emulated_devices(2):
        pool = TPool(teb, 4, chunk_frames=4, n_devices=2)
        sharded, _ = tserve(teb, reqs, 4, chunk_frames=4, n_devices=2)
    assert pool.n_shards == 2 and pool.shard_loads() == [0, 0]
    for r, b, s in zip(res, base, sharded):
        assert r.logits.shape == (r.req_id * 2 + 3, CLASSES)
        assert np.array_equal(r.logits, b.logits)
        assert np.array_equal(s.logits, b.logits)


def test_cancel_drops_live_and_retiring_sessions(model):
    _, teb = _engines(model, "auto")
    pool = TPool(teb, 2, max_frames=8, chunk_frames=4, stream_partials=True)
    assert pool.admit_stream(0, 0, feats=_feats(0, 4))
    assert pool.admit_stream(1, 0, feats=_feats(1, 4))
    pool.finish_stream(1)
    pool.tick(0)                       # 1 retires inside this chunk
    pool.cancel(1)                     # ... and is cancelled in the window
    pool.cancel(0)                     # 0 is live
    res, _ = pool.tick(4)
    assert res == [] and pool.n_active == 0 and not pool.has_pending
    assert all(p.req_id not in (0, 1) or p.t0 == 0
               for p in pool.take_partials())
    with pytest.raises(KeyError):
        pool.cancel(5)


# -- the double-buffered retirement fetch (host copies staged at snapshot) --


class _NoTensorOps:
    """While active, every tensor copy or read raises, except ``numpy()``
    of the host buffers in ``staged``."""

    NAMES = ("cpu", "to", "clone", "index_select", "__getitem__", "numpy",
             "copy_", "__array__")

    def __init__(self, monkeypatch, staged):
        self.mp = monkeypatch
        self.staged = {id(t) for t in staged}

    def __enter__(self):
        numpy = torch.Tensor.numpy
        for name in self.NAMES:
            self.mp.setattr(torch.Tensor, name, self._raise(name))

        def staged_numpy(t, *a, **k):
            if id(t) not in self.staged:
                raise AssertionError("numpy() of a tensor not staged at "
                                     "snapshot time")
            return numpy(t, *a, **k)

        self.mp.setattr(torch.Tensor, "numpy", staged_numpy)

    def __exit__(self, *exc):
        self.mp.undo()

    @staticmethod
    def _raise(name):
        def f(*a, **k):
            raise AssertionError(f"torch.Tensor.{name} called in _resolve")
        return f


def test_resolve_reads_only_host_copies_staged_at_snapshot(model,
                                                           monkeypatch):
    """The retirement, partial and telemetry fetches are staged (host
    copy + event) when the chunk that wrote them is dispatched; resolving
    them at the next boundary touches no tensor at all — in particular not
    the device logits bank, which the chunk dispatched in between
    writes."""
    _, teb = _engines(model, "auto")
    pool = TPool(teb, 3, max_frames=8, chunk_frames=4, stream_partials=True)
    feats = [_feats(60 + i, t) for i, t in enumerate([3, 4, 9])]
    for rid, f in enumerate(feats):
        assert pool.admit(StreamRequest(rid, 0, f), 0)
    assert pool.step_chunk(0) == []                 # 0 and 1 retire here
    pend = pool._pending[0]
    assert isinstance(pend.rows, HostCopy)
    assert isinstance(pool._pending_partials[0].rows, HostCopy)
    host = pend.rows.host[0]
    bank = pool._shards[0].out
    assert host.device.type == "cpu"
    assert host.untyped_storage().data_ptr() != \
        bank.untyped_storage().data_ptr()
    # what the next chunk would do to the bank before the fetch resolves
    bank.fill_(float("nan"))
    staged = (pend.rows.host + pool._pending_partials[0].rows.host
              + pool._tele_copy.host)
    with _NoTensorOps(monkeypatch, staged):
        finished = pool._resolve()
    assert sorted(r.req_id for r in finished) == [0, 1]
    e1 = TEngine(model[2], model[3], teb.cfg, device="cpu")
    for r in finished:
        np.testing.assert_allclose(
            r.logits, e1.run_utterance(feats[r.req_id]).numpy(), atol=TOL)
        assert np.isfinite(r.logits).all()
    parts = pool.take_partials()
    assert sorted((p.req_id, p.t0) for p in parts) == [(0, 0), (1, 0),
                                                       (2, 0)]
    assert all(np.isfinite(p.rows).all() for p in parts)


class _HostTransferGuard:
    """While active, records each host transfer that code in
    ``repro_torch.serving`` asks for other than through the pinned
    ``_device.upload`` and the staged ``_device.HostCopy``: a tensor built
    from host data with an explicit ``device=``, ``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()`` or ``np.asarray`` of a tensor no
    ``HostCopy`` staged, and ``torch.cuda.synchronize``.  On a card each
    of these blocks on the stream, so it waits for the chunk in flight.
    (A ``Tensor.to`` between devices cannot be told from a no-op on the
    CPU; the gpu-marked twin catches it with torch's sync debug mode.)"""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.calls = []
        self.staged = []

    @staticmethod
    def _asker():
        """The module of the first frame outside this guard and outside
        ``repro_torch._device`` (whose helpers pass a request through)."""
        f = sys._getframe(2)
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod != __name__ and mod != "repro_torch._device":
                return mod
            f = f.f_back
        return ""

    def _note(self, name):
        if self._asker().startswith("repro_torch.serving"):
            self.calls.append((name, threading.current_thread().name))

    def _is_staged(self, t):
        return any(t is h for h in self.staged)

    def __enter__(self):
        guard = self

        def factory(orig, name):
            def f(*a, **k):
                if k.get("device") is not None:
                    guard._note(name)
                return orig(*a, **k)
            return f

        def reader(orig, name, staged_ok=False):
            def f(t, *a, **k):
                if not (staged_ok and guard._is_staged(t)):
                    guard._note(name)
                return orig(t, *a, **k)
            return f

        init = HostCopy.__init__

        def staging_init(copy, *tensors):
            init(copy, *tensors)
            guard.staged.extend(copy.host)

        for name in ("as_tensor", "tensor"):
            self.mp.setattr(torch, name, factory(getattr(torch, name), name))
        for name in ("cpu", "item", "tolist"):
            self.mp.setattr(torch.Tensor, name,
                            reader(getattr(torch.Tensor, name), name))
        for name in ("numpy", "__array__"):
            self.mp.setattr(torch.Tensor, name, reader(
                getattr(torch.Tensor, name), name, staged_ok=True))
        sync = torch.cuda.synchronize
        self.mp.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (guard._note("synchronize"),
                                         sync(*a, **k))[1])
        self.mp.setattr(HostCopy, "__init__", staging_init)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def test_boundaries_ask_for_no_blocking_transfer(model, monkeypatch):
    """With observability and partials on, a pool's boundaries —
    admissions, appends, ``tick`` (dispatch, retirements, the
    observability fold), the staged backfill, ``staged_sparsity`` and the
    engine's telemetry totals — ask for no blocking host transfer; the
    one-shot ``measured_sparsity`` does, which shows the guard sees one.
    The streamed blocks, a backfill among them, still concatenate to
    each result bit for bit."""
    from repro_torch.serving import PoolObservability

    _, teb = _engines(model, "auto")
    feats = [_feats(90 + i, t) for i, t in enumerate([30, 17, 45])]
    obs = PoolObservability()
    pool = TPool(teb, 3, max_frames=8, chunk_frames=4, stream_partials=True,
                 observability=obs)
    sent, out, parts, now, ticks, backfilled = [3, 3, 3], {}, [], 0, 0, 0
    with _HostTransferGuard(monkeypatch) as guard:
        for rid, f in enumerate(feats):
            assert pool.admit_stream(rid, 0, feats=f[:3])
        while len(out) < len(feats):
            for rid, f in enumerate(feats):
                if rid in pool._by_req and sent[rid] < len(f):
                    pool.append_frames(rid, f[sent[rid]:sent[rid] + 5])
                    sent[rid] = min(len(f), sent[rid] + 5)
                    if sent[rid] == len(f):
                        pool.finish_stream(rid)
            fin, adv = pool.tick(now)
            out.update({r.req_id: r.logits for r in fin})
            now += max(adv, 1)
            parts += pool.take_partials()
            ticks += 1
            if ticks == 1:
                pool.pause_partials(1)
            if ticks == 4:
                got = sum(p.rows.shape[0] for p in parts if p.req_id == 1)
                backfilled = pool.backfill_partials(1, got)
            pool.staged_sparsity()
            pool.telemetry_totals()
        parts += pool.take_partials()
        assert guard.calls == []
        assert backfilled > 4
        pool.measured_sparsity()
        assert {name for name, _ in guard.calls} == {"cpu", "numpy"}
    assert pool.staged_sparsity() == pool.measured_sparsity()
    assert pool.staged_sparsity()["temporal_sparsity"] > 0
    widest = {}
    for rid in range(len(feats)):
        mine = sorted((p for p in parts if p.req_id == rid),
                      key=lambda p: p.t0)
        assert [p.t0 for p in mine] == list(np.cumsum(
            [0] + [p.rows.shape[0] for p in mine[:-1]]))
        assert np.array_equal(np.concatenate([p.rows for p in mine]),
                              out[rid])
        widest[rid] = max(p.rows.shape[0] for p in mine)
    assert widest[1] > 4 >= widest[0]


def test_stress_readers_against_offloaded_ticks_and_growth(model):
    """Two reader threads hammer the surface the async server's event
    loop reads while an offloaded tick runs (``bytes_per_slot``,
    ``measured_sparsity``, ``has_pending``, ``shard_loads``) as the
    driver ticks and appends past the frame bucket, which rebinds
    ``_frames`` and ``_out``; with a short switch interval and the
    lock-order recorder installed.  (Snapshots and ``peek_rows`` read the
    driver's host bookkeeping and are taken between ticks, by the driver
    itself.)  No reader may fail, the lock graph stays acyclic, and the
    served logits equal an undisturbed run's bit for bit."""
    import sys
    import threading
    import time

    from repro_torch.analysis import lockorder

    _, teb = _engines(model, "auto")
    feats = [_feats(80 + i, t) for i, t in enumerate([70, 150, 40, 95])]

    def serve(pool):
        for rid, f in enumerate(feats):
            assert pool.admit_stream(rid, 0, feats=f[:5])
        sent, out, now = [5] * len(feats), {}, 0
        while len(out) < len(feats):
            for rid, f in enumerate(feats):
                if rid in pool._by_req and sent[rid] < len(f):
                    pool.append_frames(rid, f[sent[rid]:sent[rid] + 11])
                    sent[rid] = min(len(f), sent[rid] + 11)
                    if sent[rid] == len(f):
                        pool.finish_stream(rid)
            fin, adv = pool.tick(now)
            out.update({r.req_id: r.logits for r in fin})
            now += max(adv, 1)
        return out

    ref = serve(TPool(teb, 4, max_frames=8, chunk_frames=4))
    rec = lockorder.LockOrderRecorder(slow_hold_s=30.0)
    lockorder.install(rec)
    switch = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        pool = TPool(teb, 4, max_frames=8, chunk_frames=4)
        assert isinstance(pool._state_lock, lockorder.InstrumentedLock)
        stop, errors, reads = threading.Event(), [], [0]

        def reader():
            try:
                while not stop.is_set():
                    pool.bytes_per_slot()
                    pool.measured_sparsity()
                    _ = pool.has_pending
                    assert sum(pool.shard_loads()) <= pool.capacity
                    reads[0] += 1
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        try:
            got = serve(pool)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert time.perf_counter() - t0 < 120
    finally:
        sys.setswitchinterval(switch)
        lockorder.uninstall()
    assert not errors, errors[0]
    assert reads[0] > 0 and pool.n_frame_grows >= 1
    rec.assert_acyclic()
    for rid, logits in ref.items():
        assert np.array_equal(got[rid], logits), rid
