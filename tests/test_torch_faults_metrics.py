"""Port parity, the stdlib/numpy copies: repro_torch's faults, metrics
and lockorder modules give the JAX package's answers on the same inputs
— exactly (they are the same algorithms on the host): the error catalog,
which invocations a FaultPlan fires, Backoff's seeded delays, a
registry's Prometheus text and JSON snapshot after the same updates,
TimeSeries drop counts, and a lock-order inversion found by both
recorders.  Also the pool's observability folding on the CPU: the same
workload folds the same counters in both packages.
"""
import threading

import jax
import numpy as np
import pytest

from repro.analysis import lockorder as jlock
from repro.models import lstm_am as jam
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro.serving import faults as jf
from repro.serving import metrics as jm
from repro.serving import serve_requests as jserve
from repro_torch.analysis import lockorder as tlock
from repro_torch.models import lstm_am as tam
from repro_torch.serving import BatchedSpartusEngine as TBatched
from repro_torch.serving import EngineConfig as TConfig
from repro_torch.serving import faults as tf
from repro_torch.serving import metrics as tm
from repro_torch.serving import serve_requests as tserve

PACKAGES = [(jf, jm, jlock), (tf, tm, tlock)]


def _errors(f):
    return [
        f.BadRequest("nope"), f.AdmissionShed(),
        f.AdmissionShed(retry_after_ms=80), f.SessionTimeout("idle"),
        f.DriverRecovered("lost"), f.ProtocolError("bad_json", "junk"),
        f.ProtocolError("line_too_long", "big"),
        f.InjectedFault("dispatch", 3), f.InjectedFault("dispatch", 1,
                                                        payload="poison"),
        ValueError("plain"), RuntimeError("boom"), KeyError("k"),
    ]


def test_error_catalog_matches():
    ref = [jf.error_payload(e) for e in _errors(jf)]
    port = [tf.error_payload(e) for e in _errors(tf)]
    assert port == ref
    assert tf.SITES == jf.SITES
    for name in ("BadRequest", "AdmissionShed", "SessionTimeout",
                 "DriverRecovered", "ProtocolError", "InjectedFault"):
        jc, tc = getattr(jf, name), getattr(tf, name)
        assert [b.__name__ for b in tc.__mro__] == \
            [b.__name__ for b in jc.__mro__]
        assert getattr(tc, "code", None) == getattr(jc, "code", None)
        assert getattr(tc, "retriable", None) == getattr(jc, "retriable",
                                                         None)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plans_fire_the_same_invocations(seed):
    fired = []
    for f, _, _ in PACKAGES:
        plan = f.FaultPlan.seeded(seed, n_events=6).with_events(
            f.FaultEvent("dispatch", 2, payload="poison"))
        inj = f.FaultInjector(plan)
        log = []
        for i in range(40):
            site = f.SITES[i % 2]
            try:
                inj.fire(site)
                log.append(None)
            except f.InjectedFault as e:
                log.append((e.site, e.invocation, e.payload))
        fired.append((log, [(e.site, e.at, e.payload) for e in inj.fired],
                      [(e.site, e.at) for e in plan.events],
                      [(e.site, e.at) for e in plan.events_for("dispatch")]))
    assert fired[1] == fired[0]


def test_backoff_delays_match():
    for seed in (0, 3, 99):
        delays = [[f.Backoff(seed=seed).delay(k) for k in range(10)]
                  for f, _, _ in PACKAGES]
        ceil = [[f.Backoff(seed=seed).ceiling(k) for k in range(60)]
                for f, _, _ in PACKAGES]
        assert delays[1] == delays[0] and ceil[1] == ceil[0]


def _exercise_registry(m):
    reg = m.MetricsRegistry()
    c = reg.counter("spartus_frames_total", "frames")
    c.inc(5)
    c.inc()
    g = reg.gauge("spartus_occupancy", "slots", labels={"shard": "0"})
    g.set(3)
    g.inc(2)
    reg.gauge("spartus_occupancy", "slots", labels={"shard": "1"}).set(1)
    h = reg.histogram("spartus_chunk_seconds", "chunk wall")
    for v in (5e-5, 2e-4, 0.004, 0.03, 0.5, 7.0):
        h.observe(v)
    hf = reg.histogram("spartus_chunk_advance_frames", "frames",
                       buckets=(1, 2, 4, 8))
    for v in (1, 3, 3, 9):
        hf.observe(v)
    return reg


def test_registry_exposition_matches():
    jr, tr = (_exercise_registry(m) for m in (jm, tm))
    assert tr.render_prometheus() == jr.render_prometheus()
    assert tr.snapshot() == jr.snapshot()


def test_timeseries_drops_match():
    counts = []
    for m in (jm, tm):
        ts = m.TimeSeries(maxlen=5)
        for i in range(13):
            ts.append({"chunk": i})
            if i % 4 == 0:
                ts.update_last({"lagging": i})
        counts.append((ts.n_appended, ts.n_dropped, len(ts),
                       ts.snapshot(), ts.snapshot(last=2)))
    assert counts[1] == counts[0]
    assert counts[0][:3] == (13, 8, 5)


def test_tracer_spans_match():
    names = []
    for m in (jm, tm):
        tr = m.Tracer(enabled=True, max_events=3)
        for name in ("dispatch", "snapshot_fetch", "dispatch", "pacing"):
            with tr.span(name):
                pass
        tr.instant("recovery", {"n": 1})
        names.append((tr.n_events, tr.phase_names()))
        assert m.NULL_TRACER.span("x") is m.NULL_TRACER.span("y")
    assert names[1] == names[0]


def _inversion(lk):
    """Two threads take A then B and B then A (serially, so nothing
    hangs): both recorders must report the A<->B cycle."""
    rec = lk.LockOrderRecorder(slow_hold_s=10.0)
    lk.install(rec)
    try:
        a = lk.make_lock("A")
        b = lk.make_lock("B")
        assert isinstance(a, lk.InstrumentedLock)

        def ab():
            with a, b:
                pass

        def ba():
            with b, a:
                pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        bad = lk.make_lock("C")
        bad.acquire()
        rec.note_acquire("C", id(bad))           # a re-acquire intent
        bad.release()
    finally:
        lk.uninstall()
    assert isinstance(lk.make_lock("plain"), type(threading.Lock()))
    with pytest.raises(AssertionError):
        rec.assert_acyclic()
    return (sorted(rec.edges().items()), rec.cycles(),
            len(rec.violations()), sorted(rec.hold_times()))


def test_lock_order_inversion_found_by_both_recorders():
    ref, port = _inversion(jlock), _inversion(tlock)
    assert port == ref
    assert ref[1] and ref[2] == 1


def test_pool_observability_folds_match():
    """The same chunked workload through both packages' serve_requests
    with observability on: equal counters and per-chunk samples (host
    values), incremental sparsity within 1e-6."""
    jcfg = jam.LSTMAMConfig(input_dim=20, hidden_dim=32, n_layers=2,
                            n_classes=11)
    tcfg = tam.LSTMAMConfig(input_dim=20, hidden_dim=32, n_layers=2,
                            n_classes=11)
    params = jam.cbtd_prune_stacks(jam.init_params(jax.random.key(0), jcfg),
                                   gamma=0.75, m=4)
    tparams = tam.params_from_numpy(jax.device_get(params), device="cpu")
    kw = dict(theta=0.05, gamma=0.75, m=4, capacity_frac=1.0)
    rng = np.random.default_rng(4)
    reqs = [(i, rng.standard_normal((t, 20)).astype(np.float32))
            for i, t in enumerate([7, 12, 3, 9, 5])]
    obs = [jm.PoolObservability(), tm.PoolObservability()]
    jserve(JBatched(params, jcfg, JConfig(**kw)), reqs, 3, chunk_frames=4,
           observability=obs[0])
    tserve(TBatched(tparams, tcfg, TConfig(**kw), device="cpu"), reqs, 3,
           chunk_frames=4, observability=obs[1])
    for name in ("c_dispatches", "c_frames", "c_admissions",
                 "c_completed", "g_occupancy"):
        assert getattr(obs[1], name).value == getattr(obs[0], name).value
    keep = ("chunk", "occupancy", "active_frac", "frames", "admissions",
            "retirements", "shard_loads", "samples_inc")
    js, ts = (o.timeseries.snapshot() for o in obs)
    assert [{k: s[k] for k in keep} for s in ts] == \
        [{k: s[k] for k in keep} for s in js]
    np.testing.assert_allclose(
        [s["temporal_sparsity_inc"] for s in ts],
        [s["temporal_sparsity_inc"] for s in js], atol=1e-6)
