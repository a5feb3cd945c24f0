"""The pool's launch counters and the tick's phase spans, on the CPU.

* The counters (``kernels/counters.py``) that the dense-mirror / scatter
  SpMV and HPE launches keep per layer equal an independent recount from
  the same calls' deltas and NZI lists, with the definitions of the
  benchmark's roofline inputs (``bench/counting.py``): ``union`` = columns
  fired in some row of a call, ``fired`` = nonzero entries, and
  ``staged`` = the union of each pass of the mirror kernel's rows (the
  live entries on the scatter route).  Logits are bit-identical with
  counting on and off, and the boundary samples carry the increments.
* Counting follows the pool: a pool without observability, or a step
  outside any pool, selects nothing, and a launch that raises leaves
  nothing selected.
* 1 <= staged / union <= ceil(B / rows a pass) on the dense mirror.
* A recorder that has nothing but ``span()`` sees the tick's leaf spans
  on the worker thread and the event loop's on the loop thread, and the
  samples carry the tick's thread hand-off.
* ``mean_host_overlap_frac`` is the mean of the chunks' fractions, and
  the tracer stamps spans on ``time.perf_counter``.

No JAX: the port alone, small shapes.
"""
import asyncio
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import QuantConfig
from repro_torch.kernels import counters as kcount
from repro_torch.kernels import ops
from repro_torch.models import lstm_am
from repro_torch.serving import (
    AsyncSpartusServer,
    BatchedSpartusEngine,
    EngineConfig,
    PoolObservability,
    Tracer,
    serve_requests,
)

INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
GAMMA, M = 0.75, 8


@pytest.fixture(scope="module")
def params():
    cfg = lstm_am.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                               n_layers=2, n_classes=CLASSES)
    p = lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return lstm_am.cbtd_prune_stacks(p, gamma=GAMMA, m=M), cfg


def _engine(params, route, quant, capacity_frac=0.5):
    p, cfg = params
    ecfg = EngineConfig(theta=0.05, gamma=GAMMA, m=M, spmv_path=route,
                        capacity_frac=capacity_frac,
                        quant=QuantConfig() if quant else None)
    return BatchedSpartusEngine(p, cfg, ecfg, device="cpu")


def _requests(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.standard_normal((t, INPUT_DIM)).astype(np.float32))
            for i, t in enumerate(lens)]


def _passes(b):
    """The mirror kernel's rows a pass at B = b, recomputed: RB is the
    least of 1, 2, 4, ..., 32 that holds min(b, 32) rows."""
    return next(r for r in (1, 2, 4, 8, 16, 32) if r >= min(b, 32))


class _Recount:
    """Wraps the ops entry points the benchmark wraps and recounts each
    call from its own inputs, layer by layer (the engine calls layer 0,
    1, ..., then layer 0 again)."""

    def __init__(self, monkeypatch, n_layers):
        self.n_layers = n_layers
        self.calls = []                  # (kernel, calls, fired, union,
        #                                   staged) per call
        mirror, spmv = ops._mirror_matmul, ops.stsp_spmv_batch

        def counted_mirror(ds, wt, scale=None):
            fired = ds != 0
            b = ds.shape[0]
            rows = _passes(b)
            staged = sum(int(fired[r:r + rows].any(0).sum())
                         for r in range(0, b, rows))
            self.calls.append(("dense_mirror", 1, int(fired.sum()),
                               int(fired.any(0).sum()), staged))
            return mirror(ds, wt, scale)

        def counted_spmv(val, lidx, idx, ds_vals, *, s, scale=None):
            fired = (ds_vals != 0).to(torch.float32)
            mark = torch.zeros(val.shape[0])
            mark.scatter_reduce_(0, idx.reshape(-1).long(),
                                 fired.reshape(-1), reduce="amax")
            n = int(fired.sum())
            self.calls.append(("stsp_spmv", 1, n, int(mark.sum()), n))
            return spmv(val, lidx, idx, ds_vals, s=s, scale=scale)

        monkeypatch.setattr(ops, "_mirror_matmul", counted_mirror)
        monkeypatch.setattr(ops, "stsp_spmv_batch", counted_spmv)

    def per_layer(self):
        out = np.zeros((self.n_layers, 4), np.int64)
        for i, (_, *counts) in enumerate(self.calls):
            out[i % self.n_layers] += counts
        return out


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("route", ["dense", "scatter"])
def test_counters_equal_a_recount_and_leave_logits_bit_identical(
        params, monkeypatch, route, quant):
    reqs = _requests([9, 6, 12, 7, 15])
    plain, _ = serve_requests(_engine(params, route, quant), reqs, 3,
                              chunk_frames=4)
    engine = _engine(params, route, quant)
    recount = _Recount(monkeypatch, n_layers=2)
    obs = PoolObservability()
    got, stats = serve_requests(engine, reqs, 3, chunk_frames=4,
                                observability=obs)
    assert stats.n_dispatches >= 2
    kernel = "dense_mirror" if route == "dense" else "stsp_spmv"
    assert {k for k, *_ in recount.calls} == {kernel}
    assert engine.counters.kernels == (kernel, kernel)
    counts = engine.counters.counts.numpy()
    np.testing.assert_array_equal(counts, recount.per_layer())
    assert int(engine.counters.marks.sum()) == 0      # every HPE cleared
    for a, b in zip(got, plain):
        assert np.array_equal(a.logits, b.logits)
    # the samples hold every window but the last, which flush resolves
    samples = obs.timeseries.snapshot()
    summed = {f: sum(s[f"{kernel}_{f}_inc"] for s in samples)
              for f in kcount.FIELDS}
    other = "stsp_spmv" if route == "dense" else "dense_mirror"
    assert all(s[f"{other}_calls_inc"] == 0 for s in samples)
    assert 0 < summed["calls"] <= counts[:, 0].sum()
    obs.flush_totals()
    snap = obs.registry.snapshot()
    for i, field in enumerate(kcount.FIELDS):
        for layer in range(2):
            key = (f'spartus_kernel_{field}_total{{kernel="{kernel}",'
                   f'layer="{layer}"}}')
            assert snap[key]["value"] == counts[layer, i]


@pytest.mark.parametrize("route", ["dense", "scatter"])
def test_counters_of_a_pool_past_one_mirror_pass(params, monkeypatch,
                                                 route):
    """40 slots, all busy at once: the mirror kernel takes two passes of
    rows a call, and each stages its own union."""
    rng = np.random.default_rng(6)
    reqs = [(0, rng.standard_normal((t, INPUT_DIM)).astype(np.float32))
            for t in rng.integers(8, 20, 50)]
    engine = _engine(params, route, False)
    recount = _Recount(monkeypatch, n_layers=2)
    serve_requests(engine, reqs, 40, chunk_frames=4,
                   observability=PoolObservability())
    counts = engine.counters.counts.numpy()
    np.testing.assert_array_equal(counts, recount.per_layer())
    if route == "dense":
        assert (counts[:, 3] > counts[:, 2]).all()
    else:
        assert (counts[:, 3] == counts[:, 1]).all()


def _watch_selection(monkeypatch):
    """Record the layer selected on the calling thread at every product
    call (what the kernel wrapper would pass its entry point)."""
    seen = []
    mirror, spmv = ops._mirror_matmul, ops.stsp_spmv_batch

    def watched_mirror(ds, wt, scale=None):
        seen.append(kcount.selected.layer)
        return mirror(ds, wt, scale)

    def watched_spmv(val, lidx, idx, ds_vals, *, s, scale=None):
        seen.append(kcount.selected.layer)
        return spmv(val, lidx, idx, ds_vals, s=s, scale=scale)

    monkeypatch.setattr(ops, "_mirror_matmul", watched_mirror)
    monkeypatch.setattr(ops, "stsp_spmv_batch", watched_spmv)
    return seen


@pytest.mark.parametrize("route", ["dense", "scatter"])
def test_a_pool_without_observability_counts_nothing(params, monkeypatch,
                                                      route):
    """Counting follows the pool, not the engine: a pool without
    observability, built on an engine that a pool with it has counted
    in, and a step outside any pool, select no counters, so the kernels
    take null pointers, and the engine's counts stay where they were."""
    engine = _engine(params, route, False)
    reqs = _requests([9, 6, 12, 7])
    seen = _watch_selection(monkeypatch)
    serve_requests(engine, reqs, 3, chunk_frames=4,
                   observability=PoolObservability())
    assert seen and all(layer is not None for layer in seen)
    before = engine.counters.counts.clone()
    seen.clear()
    serve_requests(engine, reqs, 3, chunk_frames=4)
    serve_requests(engine, reqs, 3)                  # the per-frame tick
    state = engine.init_state(2)
    every = torch.ones(2, dtype=torch.bool)
    engine.step_frames(state, torch.randn(2, 4, INPUT_DIM), every, every)
    assert seen and all(layer is None for layer in seen)
    assert torch.equal(engine.counters.counts, before)
    assert not kcount.selected.counting


def test_a_step_that_raises_leaves_nothing_selected(params, monkeypatch):
    """A layer's launch that raises mid-step (a launch error, a bad
    input) leaves neither a layer selected nor counting on, so the next
    call on the thread counts into nothing."""
    engine = _engine(params, "dense", False)
    engine.count_kernels()
    calls = []

    def failing(ds, wt, scale=None):
        calls.append(kcount.selected.layer)
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ops, "_mirror_matmul", failing)
    state = engine.init_state(2)
    every = torch.ones(2, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="launch failed"):
        with kcount.counting():
            engine.step_frames(state, torch.randn(2, 4, INPUT_DIM), every,
                               every)
    assert calls == [engine.counters.layers[0]]
    assert kcount.selected.layer is None
    assert not kcount.selected.counting


@pytest.mark.parametrize("b", [1, 5, 32, 33, 70, 130])
def test_dense_mirror_restage_within_its_bounds(b):
    """Straight through the ops entry points, as the engine calls them,
    on deltas with about 30% fired: union <= staged <= ceil(B / RB) x
    union, both ends reached where they can be."""
    gen = torch.Generator().manual_seed(b)
    q, n = 96, 40
    ds = torch.randn((b, q), generator=gen)
    ds = torch.where(torch.rand((b, q), generator=gen) < 0.3, ds,
                     torch.zeros_like(ds))
    wt = torch.randn((q, n), generator=gen)
    counters = kcount.KernelCounters([q], ["dense_mirror"], ds.device)
    layer = counters.layers[0]
    kcount.select(layer)
    try:
        y = ops._mirror_matmul(ds, wt)
        ops.lstm_pointwise_step(torch.zeros((b, n)), y, torch.zeros(
            (b, n // 4)), torch.zeros((b, n // 4)))
    finally:
        kcount.select(None)
    calls, fired, union, staged = counters.counts[0].tolist()
    assert (calls, fired) == (1, int((ds != 0).sum()))
    assert union == int((ds != 0).any(0).sum())
    rows = _passes(b)
    assert union <= staged <= math.ceil(b / rows) * union
    if b <= 32:
        assert staged == union                 # one pass
    else:
        assert staged > union                  # each pass stages anew


class _Spans:
    """A recorder with nothing but ``span()``, as the benchmark's: each
    span's name, thread name, start and end."""

    def __init__(self):
        self.spans = []
        self._lock = threading.Lock()

    def span(self, name):
        rec = self

        class _S:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                with rec._lock:
                    rec.spans.append((name, threading.current_thread().name,
                                      self.t0, time.perf_counter()))
        return _S()


WORKER = {"admission_upload", "dispatch", "snapshot_fetch",
          "slot_bookkeeping", "partials_stage", "obs_fold"}
LOOP = {"delivery_pump", "pacing_idle", "loop_service", "loop_fold",
        "stream_open"}


def test_async_server_spans_tile_the_tick_on_both_threads(params):
    engine = _engine(params, "dense", False)
    rec = _Spans()
    obs = PoolObservability(tracer=rec)

    async def main():
        reqs = _requests([14, 9, 21, 5, 17, 11], seed=3)
        async with AsyncSpartusServer(engine, 3, chunk_frames=4,
                                      observability=obs) as srv:
            async def client(feats):
                handle = await srv.stream(want_partials=True)
                for i in range(0, len(feats), 4):
                    await handle.send(feats[i:i + 4])
                    await asyncio.sleep(0)
                handle.close()
                async for _ in handle:
                    pass
                return await handle.result()
            return await asyncio.gather(*(client(f) for _, f in reqs))

    results = asyncio.run(main())
    assert len(results) == 6
    by_thread = {}
    for name, thread, a, b in rec.spans:
        assert b >= a
        by_thread.setdefault(thread, []).append((a, b, name))
    worker = [t for t in by_thread if t.startswith("spartus-tick")]
    assert len(worker) == 1
    loop = [t for t in by_thread if t not in worker]
    assert len(loop) == 1
    assert {n for _, _, n in by_thread[worker[0]]} == WORKER
    assert {n for _, _, n in by_thread[loop[0]]} == LOOP
    # leaf spans: none covers another on its thread, but for a client's
    # stream_open, which runs while the server's loop yields in
    # pacing_idle
    def disjoint(spans):
        spans = sorted(spans)
        return all(b[0] >= a[1] for a, b in zip(spans, spans[1:]))

    assert disjoint(by_thread[worker[0]])
    on_loop = by_thread[loop[0]]
    assert disjoint([s for s in on_loop if s[2] != "pacing_idle"])
    assert disjoint([s for s in on_loop if s[2] != "stream_open"])
    samples = obs.timeseries.snapshot()
    assert samples and all("t_mono" in s for s in samples)
    assert all(s["handoff_s"] > 0 for s in samples)
    handoff = obs.registry.snapshot()["spartus_tick_handoff_seconds"]
    assert handoff["count"] >= len(samples)
    t_mono = [s["t_mono"] for s in samples]
    assert t_mono == sorted(t_mono)
    assert rec.spans[0][2] <= t_mono[0] <= time.perf_counter()


def test_mean_host_overlap_frac_is_the_chunks_mean(params):
    obs = PoolObservability()
    _, stats = serve_requests(_engine(params, "scatter", False),
                              _requests([9, 6, 12, 7, 15, 4]), 3,
                              chunk_frames=4, observability=obs)
    fracs = [s["host_overlap_frac"] for s in obs.timeseries.snapshot()]
    assert len(fracs) == stats.n_dispatches >= 2
    assert stats.host_overlap_frac == pytest.approx(np.mean(fracs),
                                                    rel=1e-12, abs=0)


def test_tracer_stamps_spans_on_perf_counter():
    tracer = Tracer()
    t0 = time.perf_counter()
    with tracer.span("dispatch"):
        pass
    t1 = time.perf_counter()
    before = time.time_ns() - time.perf_counter_ns()
    out = json.loads(tracer.to_json())
    after = time.time_ns() - time.perf_counter_ns()
    (ev,) = out["traceEvents"]
    assert t0 * 1e6 <= ev["ts"] <= ev["ts"] + ev["dur"] <= t1 * 1e6
    offset = out["otherData"]["perf_counter_to_unix_ns"]
    assert abs(offset - before) < 1e6 and abs(offset - after) < 1e6


def test_recent_timeseries_outlive_their_server(params):
    from repro_torch.serving.metrics import (RECENT_TIMESERIES,
                                             recent_timeseries)

    obs = PoolObservability(tracer=_Spans())

    async def main():
        reqs = _requests([10, 7, 13], seed=5)
        async with AsyncSpartusServer(_engine(params, "dense", False), 2,
                                      chunk_frames=4,
                                      observability=obs) as srv:
            return await asyncio.gather(*(srv.submit(f) for _, f in reqs))

    assert len(asyncio.run(main())) == 3
    want = obs.timeseries.snapshot()
    assert want and all("t_mono" in s and "handoff_s" in s for s in want)
    del obs
    assert [s for ts in recent_timeseries() for s in ts.snapshot()
            if s in want] == want
    for _ in range(RECENT_TIMESERIES):       # the record stays bounded
        PoolObservability()
    got = recent_timeseries()
    assert len(got) == RECENT_TIMESERIES
    assert all(len(ts) == 0 for ts in got)
