"""Live serving observability: metrics registry, per-chunk time series,
and driver-phase tracing — port of ``repro/serving/metrics.py``, which is
stdlib + numpy: a copy whose lock factory is the port's ``lockorder``.

The serving stack's headline quantities — frames/s, per-session latency,
the measured spatio-temporal sparsity behind the paper's 46x speedup —
were only reportable *after* a run ended (`ServeStats` is reduced once in
`aggregate_stats`; `measured_sparsity` is a one-shot fetch).  A pool
serving long-lived streams needs them live: ESE frames sparse-LSTM
serving as a system whose batch occupancy must be observable under real
traffic, and SHARP's dynamic scheduling presupposes runtime activity
statistics.  This module is that data plane, in three pieces:

* **`MetricsRegistry`** — process-wide counters, gauges and fixed-bucket
  histograms with Prometheus-style text exposition
  (`render_prometheus`) and a JSON snapshot (`snapshot`).  Thread-safe:
  the async driver may fold from a worker thread while an admin
  endpoint scrapes from the event loop.
* **`TimeSeries`** — a bounded ring buffer (default 4096 samples) of
  per-chunk pool-health samples: occupancy, active fraction, dispatch
  wall time, host overlap, admissions/retirements per chunk, per-shard
  loads, lagging sessions, partial-queue depths, and the *incremental*
  temporal sparsity of just that window.
* **`Tracer`** — Chrome-trace-event span instrumentation of the tick
  loop's phases (admission-wave upload, dispatch, snapshot D2H fetch,
  delivery pump, pacing idle), loadable in Perfetto / `chrome://tracing`.
  Disabled tracing costs one attribute read and a no-op context manager
  per phase (`NULL_TRACER`), so the hot path never pays for it.

The port adds what a CUDA graph of the chunk and the host's idle time
need measured from inside the program:

* the pool engines' **launch counters** (``kernels/counters.py``), which
  ride the telemetry totals' lagged copy into
  ``spartus_kernel_{calls,fired,union,staged}_total{kernel=,layer=}``
  (and the dense route's clip: ``spartus_kernel_{rows,clipped}_total
  {kernel="capacity_clip",layer=}``) and each sample's
  ``<kernel>_<field>_inc`` (summed over layers and shards, one window
  late like ``temporal_sparsity_inc``);
* the tick's **phases** as leaf spans, none covering another on its
  thread (but a client's ``stream_open``, which runs while the loop
  yields in ``pacing_idle``), so a gap in the device's work falls under
  the phase that was running:

  ================  ===========  ==========================================
  span              thread       what
  ================  ===========  ==========================================
  admission_upload  tick worker  staged admissions and appends uploaded
  dispatch          tick worker  the chunk's launches
  snapshot_fetch    tick worker  the previous chunk's copies resolved
  slot_bookkeeping  tick worker  every walk over the slots, retirements
  partials_stage    tick worker  D2H copies staged behind the chunk
  obs_fold          tick worker  the boundary fold
  loop_service      event loop   pump, lagging backfill, reaper, work test
  delivery_pump     event loop   partials and results to the clients
  loop_fold         event loop   the loop side's fold
  pacing_idle       event loop   the pacing wait, where clients run
  stream_open       event loop   the synchronous part of ``stream()``
  ================  ===========  ==========================================

* the **hand-off** between the two threads, which no span can hold: with
  observability on, the async server reads ``time.perf_counter`` at
  submit, worker start, worker end and loop resume, and folds (start -
  submit) + (resume - end) into ``spartus_tick_handoff_seconds`` and the
  sample's ``handoff_s``; each sample also holds ``t_mono``, its
  boundary's ``time.perf_counter()``, and `recent_timeseries()` keeps
  the newest pools' series after their servers are gone;
* **one clock**: `Tracer` stamps spans in microseconds of
  ``time.perf_counter()``, and the JSON it writes holds
  ``otherData.perf_counter_to_unix_ns``, read at the dump: an event that
  torch.profiler stamps at ``e`` Unix-epoch nanoseconds lies at ``(e -
  perf_counter_to_unix_ns) / 1e3`` on the trace's axis, so a
  ``launch/serve.py --trace`` file and a device trace of the same
  process line up.

`PoolObservability` bundles the three and owns the **boundary-fold
design rule** (the `TelemetryState` rule extended): every hot-path
source is folded at chunk boundaries ONLY, on host values the pool
already has — never a new per-frame host sync.  The one device-derived
signal, incremental sparsity, is obtained by *diffing the existing
`[L, B]` telemetry accumulators between boundaries*: after each chunk
dispatch a tiny device reduction (`telemetry.fold_totals`, three
scalars) is enqueued against the fresh accumulators, and its value is
fetched one boundary later — the same detach-now/fetch-next-chunk
cadence as retirement logits, so the in-flight chunk is never synced on
and the compiled step function is bit-identical with observability on
or off (pinned in tests/test_observability.py).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.counters import CLIP, CLIP_FIELDS, KERNELS
from repro_torch.kernels.counters import FIELDS as KERNEL_FIELDS

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TimeSeries", "Tracer", "NULL_TRACER", "PoolObservability",
    "DEFAULT_TIMESERIES_LEN", "recent_timeseries",
]

#: default bound on the per-chunk time-series ring buffer (samples).
DEFAULT_TIMESERIES_LEN = 4096

#: default histogram buckets (seconds) for dispatch/chunk wall times:
#: roughly log-spaced from 100 us to 3 s, covering CPU dev boxes through
#: accelerator chunks.
DEFAULT_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                        1.0, 3.0)

#: buckets (seconds) of the tick's thread hand-off: tens of microseconds
#: on an idle host to tens of milliseconds behind a busy event loop
HANDOFF_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1)

#: how many of the process's newest `PoolObservability` time series
#: `recent_timeseries` keeps past their pools
RECENT_TIMESERIES = 4


def _make_lock(name: str) -> threading.Lock:
    """Lock factory: a plain ``threading.Lock`` normally, an instrumented
    lock feeding the acquisition-order recorder when one is installed
    (``repro_torch.analysis.lockorder`` — imported lazily, at first registry /
    ring construction, so merely importing this module stays light)."""
    try:
        from repro_torch.analysis import lockorder
    except ImportError:          # analysis layer absent: never block serving
        return threading.Lock()
    return lockorder.make_lock(name)


def _host_values(x: Any) -> np.ndarray:
    """Host float64 values of a fold source: a staged device->host copy
    (anything with ``wait()``, such as the pool's ``HostCopy``, whose
    wait covers only the copy's own event) or an array-like."""
    wait = getattr(x, "wait", None)
    return np.asarray(wait() if wait is not None else x, np.float64)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing counter (float, exact to 2^53)."""

    _guarded_by_ = {"_value": "_lock"}

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (occupancy, queue depth, ...)."""

    _guarded_by_ = {"_value": "_lock"}

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative-bucket exposition, Prometheus
    convention: ``bucket[i]`` counts observations <= ``buckets[i]``, plus
    an implicit +Inf bucket)."""

    _guarded_by_ = {"_counts": "_lock", "_sum": "_lock", "_count": "_lock"}

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: needs >= 1 bucket")
        # per-bucket (non-cumulative) counts + the overflow bucket:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = int(np.searchsorted(self.buckets, v, side="left"))
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] including the +Inf bucket."""
        return self.stats()[2]

    def stats(self) -> Tuple[int, float, List[Tuple[float, int]]]:
        """``(count, sum, cumulative buckets)`` read under ONE lock
        acquisition — the only way to get a self-consistent view while
        observers keep folding.  Reading ``count``/``sum``/
        ``cumulative()`` separately can tear: an ``observe`` landing
        between the reads makes the +Inf bucket disagree with ``_count``
        (scrapers and Prometheus recording rules treat that as data
        corruption)."""
        out: List[Tuple[float, int]] = []
        acc = 0
        with self._lock:
            for le, c in zip(self.buckets, self._counts):
                acc += c
                out.append((le, acc))
            out.append((float("inf"), acc + self._counts[-1]))
            return self._count, self._sum, out


class MetricsRegistry:
    """Process-wide named metrics with Prometheus text exposition and a
    JSON snapshot API.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent for
    the same (name, labels); re-declaring a name as a different type
    raises).  One registry is typically shared by the pool, the async
    driver and the admin endpoint.
    """

    _guarded_by_ = {"_metrics": "_lock"}

    def __init__(self) -> None:
        # one shared lock for the registry map AND every metric it
        # creates (passed into each constructor), made through the
        # lock-order factory so the chaos recorder sees it:
        self._lock = _make_lock("MetricsRegistry._lock")
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw):
        lab = tuple(sorted((labels or {}).items()))
        key = (name, lab)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, self._lock, labels=lab, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dict: ``{name{labels}: {"type", "value"|...}}``."""
        out: Dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for (name, lab), m in metrics:
            key = name + _fmt_labels(lab)
            if isinstance(m, Histogram):
                count, total, cum = m.stats()   # one lock: no torn reads
                out[key] = {
                    "type": "histogram", "count": count, "sum": total,
                    "buckets": {str(le): c for le, c in cum
                                if np.isfinite(le)},
                }
            else:
                out[key] = {
                    "type": "counter" if isinstance(m, Counter) else "gauge",
                    "value": m.value,
                }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.items())
        lines: List[str] = []
        seen_header = set()
        for (name, lab), m in sorted(metrics, key=lambda kv: kv[0]):
            kind = ("counter" if isinstance(m, Counter)
                    else "gauge" if isinstance(m, Gauge) else "histogram")
            if name not in seen_header:
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {kind}")
                seen_header.add(name)
            if isinstance(m, Histogram):
                count, total, cum = m.stats()   # one lock: no torn reads
                for le, c in cum:
                    le_s = "+Inf" if not np.isfinite(le) else repr(le)
                    extra = dict(lab)
                    extra["le"] = le_s
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(tuple(sorted(extra.items())))} {c}")
                lines.append(f"{name}_sum{_fmt_labels(lab)} {total}")
                lines.append(f"{name}_count{_fmt_labels(lab)} {count}")
            else:
                v = m.value
                v_s = repr(v) if v != int(v) else str(int(v))
                lines.append(f"{name}{_fmt_labels(lab)} {v_s}")
        return "\n".join(lines) + "\n"


class TimeSeries:
    """Bounded ring buffer of per-chunk samples (plain dicts).

    Appends are O(1) and drop the oldest sample past ``maxlen`` — a
    long-running server holds a fixed-size window, not its whole
    history.  ``snapshot(last=N)`` returns copies, safe to serialize
    while the driver keeps appending."""

    _guarded_by_ = {"_samples": "_lock", "_n_appended": "_lock"}

    def __init__(self, maxlen: int = DEFAULT_TIMESERIES_LEN):
        if maxlen < 1:
            raise ValueError("TimeSeries maxlen must be >= 1")
        self.maxlen = maxlen
        self._lock = _make_lock("TimeSeries._lock")
        self._samples: deque = deque(maxlen=maxlen)
        self._n_appended = 0    # total ever appended (detects drops)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def n_appended(self) -> int:
        with self._lock:
            return self._n_appended

    @property
    def n_dropped(self) -> int:
        # one acquisition: reading the pair separately can tear (an
        # append between the reads yields a phantom drop count).
        with self._lock:
            return self._n_appended - len(self._samples)

    def append(self, sample: Dict[str, Any]) -> None:
        with self._lock:
            self._samples.append(sample)
            self._n_appended += 1

    def update_last(self, fields: Dict[str, Any]) -> None:
        """Merge fields into the most recent sample (the async driver
        amends the pool's boundary sample with loop-side signals —
        lagging count, queue depths — after the tick returns)."""
        with self._lock:
            if self._samples:
                self._samples[-1].update(fields)

    def snapshot(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            samples = list(self._samples)
        if last is not None and last >= 0:
            samples = samples[-last:]
        return [dict(s) for s in samples]


#: the time series of the newest `PoolObservability` objects made in this
#: process; appended by ``PoolObservability.__init__`` (an atomic deque
#: append), bounded so the process holds at most a few rings
_recent_series: deque = deque(maxlen=RECENT_TIMESERIES)


def recent_timeseries() -> List["TimeSeries"]:
    """The time series of the newest `RECENT_TIMESERIES` pools'
    observabilities made in this process, oldest first.  They outlive
    their pools and servers, so a run's boundary samples (``t_mono``,
    ``handoff_s``, the launch counters' increments) can be read once the
    server that folded them is gone."""
    return list(_recent_series)


class _NullSpan:
    """Reusable no-op context manager: disabled tracing allocates
    nothing per phase."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_t0")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._complete(self._name, self._t0, time.perf_counter())


class Tracer:
    """Chrome trace-event recorder for the driver's tick-loop phases.

    ``with tracer.span("dispatch"): ...`` records one complete ("ph":
    "X") event; ``to_json()`` / ``dump(path)`` emit the
    ``{"traceEvents": [...]}`` JSON that Perfetto and chrome://tracing
    load directly.  Events are stamped in microseconds of
    ``time.perf_counter()``; ``otherData.perf_counter_to_unix_ns``,
    read when the JSON is written, is what to add to ``ts * 1e3`` to get
    the Unix-epoch nanoseconds that torch.profiler stamps device events
    with, so the two traces of one run line up.  Events are bounded
    (``max_events``, oldest dropped) so an always-on tracer cannot grow
    without bound.  A disabled tracer
    (``enabled=False``, or the shared `NULL_TRACER`) returns a no-op
    span: the instrumentation sites cost one attribute check.
    """

    _guarded_by_ = {"_events": "_lock"}

    def __init__(self, enabled: bool = True, max_events: int = 1_000_000):
        self.enabled = enabled
        # a disabled tracer (incl. the module-level NULL_TRACER) keeps a
        # plain lock so importing this module never touches the analysis
        # layer; enabled tracers go through the recorder factory.
        self._lock = (_make_lock("Tracer._lock") if enabled
                      else threading.Lock())
        self._events: deque = deque(maxlen=max_events)

    def span(self, name: str):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def _complete(self, name: str, t0: float, t1: float) -> None:
        ev = {
            "name": name, "ph": "X", "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6,
        }
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None
                ) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "g", "pid": 1,
              "tid": threading.get_ident() & 0xFFFF,
              "ts": time.perf_counter() * 1e6}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    def phase_names(self) -> List[str]:
        with self._lock:
            return sorted({e["name"] for e in self._events})

    def to_json(self) -> str:
        with self._lock:
            events = list(self._events)
        offset = time.time_ns() - time.perf_counter_ns()
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms",
                           "otherData": {"clock": "perf_counter",
                                         "perf_counter_to_unix_ns": offset}})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


#: the shared disabled tracer: pool/driver phase sites call
#: ``tracer.span(...)`` unconditionally; against NULL_TRACER that is one
#: attribute read and a shared no-op context manager.
NULL_TRACER = Tracer(enabled=False, max_events=1)


class PoolObservability:
    """The pool/driver-facing bundle: one registry + one time-series ring
    + one tracer, plus the boundary-fold state machine.

    Construction registers the metric family below; `SessionPool` calls
    ``fold_chunk`` once per dispatch boundary (and ``fold_results`` /
    ``fold_admissions`` as the bookkeeping happens), all on host values
    the pool already computed — the fold never adds a device sync (the
    incremental-sparsity totals are enqueued now, fetched at the NEXT
    boundary, exactly like retirement logits).

    Metric catalog (see docs/observability.md):

    counters
        ``spartus_dispatches_total``      step/chunk dispatches
        ``spartus_frames_total``          (slot, frame) samples consumed
        ``spartus_admissions_total``      sessions bound to a slot
        ``spartus_completed_total``       results delivered, complete
        ``spartus_truncated_total``       results delivered, truncated
        ``spartus_cancelled_total``       sessions reaped by cancel()
        ``spartus_timeseries_dropped_total``  ring-buffer evictions
        ``spartus_faults_total{site=}``   faults observed, by site
        ``spartus_shed_total``            admissions shed under overload
        ``spartus_idle_timeouts_total``   sessions reaped by idle timeout
        ``spartus_bad_requests_total``    payloads rejected by validation
        ``spartus_recoveries_total``      watchdog pool rebuilds
        ``spartus_sessions_salvaged_total``  sessions restored by recovery
        ``spartus_sessions_lost_total``   sessions failed by recovery
        ``spartus_checkpoints_total``     pool checkpoints written
        ``spartus_sessions_restored_total``  sessions restored from ckpt
        ``spartus_kernel_{calls,fired,union,staged}_total{kernel=,layer=}``
                                          the pool engine's launch counters
    gauges
        ``spartus_occupancy``             occupied slots at the boundary
        ``spartus_active_fraction``       active slots / capacity
        ``spartus_shard_load{shard=}``    occupied slots per shard
        ``spartus_lagging_sessions``      async slow consumers (paused)
        ``spartus_partial_queue_depth_max``  deepest client queue
        ``spartus_connected_clients``     async streams open
        ``spartus_host_overlap_frac``     last chunk's overlap fraction
        ``spartus_temporal_sparsity``     incremental, last window
        ``spartus_slot_bytes``            device bytes per resident session
    histograms
        ``spartus_dispatch_seconds``      dispatch call wall time
        ``spartus_chunk_seconds``         full boundary wall time
        ``spartus_chunk_advance_frames``  frames advanced per chunk
        ``spartus_restore_seconds``       checkpoint/restore wall time
        ``spartus_tick_handoff_seconds``  async tick's thread hand-off
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 timeseries_len: int = DEFAULT_TIMESERIES_LEN,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.timeseries = TimeSeries(timeseries_len)
        _recent_series.append(self.timeseries)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        r = self.registry
        self.c_dispatches = r.counter(
            "spartus_dispatches_total", "step/chunk dispatches")
        self.c_frames = r.counter(
            "spartus_frames_total", "(slot, frame) samples consumed")
        self.c_admissions = r.counter(
            "spartus_admissions_total", "sessions bound to a pool slot")
        self.c_completed = r.counter(
            "spartus_completed_total", "complete results delivered")
        self.c_truncated = r.counter(
            "spartus_truncated_total", "truncated results delivered")
        self.c_cancelled = r.counter(
            "spartus_cancelled_total", "sessions reaped by cancel()")
        self.c_ts_dropped = r.counter(
            "spartus_timeseries_dropped_total",
            "time-series samples evicted by the ring bound")
        self.g_occupancy = r.gauge(
            "spartus_occupancy", "occupied slots at the last boundary")
        self.g_active_frac = r.gauge(
            "spartus_active_fraction", "active slots / capacity")
        self.g_lagging = r.gauge(
            "spartus_lagging_sessions", "async slow consumers (paused)")
        self.g_queue_depth = r.gauge(
            "spartus_partial_queue_depth_max",
            "deepest async partial-logit queue")
        self.g_connected = r.gauge(
            "spartus_connected_clients", "async streams open")
        self.g_overlap = r.gauge(
            "spartus_host_overlap_frac",
            "host-work fraction of the last chunk's wall time")
        self.g_sparsity = r.gauge(
            "spartus_temporal_sparsity",
            "incremental temporal sparsity of the last folded window")
        self.g_slot_bytes = r.gauge(
            "spartus_slot_bytes",
            "device bytes per resident session (state + buffers + the "
            "slot's share of the packed weights)")
        self.h_dispatch = r.histogram(
            "spartus_dispatch_seconds", "dispatch call wall time")
        self.h_chunk = r.histogram(
            "spartus_chunk_seconds", "chunk boundary wall time")
        self.h_advance = r.histogram(
            "spartus_chunk_advance_frames", "frames advanced per chunk",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        # robustness layer (docs/robustness.md): fault/shed/timeout
        # counters, recovery outcome counters, restore-latency histogram.
        self.c_shed = r.counter(
            "spartus_shed_total", "admissions shed under overload")
        self.c_timeouts = r.counter(
            "spartus_idle_timeouts_total",
            "sessions reaped by the idle timeout")
        self.c_bad_requests = r.counter(
            "spartus_bad_requests_total",
            "payloads rejected by admission validation")
        self.c_recoveries = r.counter(
            "spartus_recoveries_total", "driver watchdog pool rebuilds")
        self.c_salvaged = r.counter(
            "spartus_sessions_salvaged_total",
            "sessions checkpoint-restored by a watchdog recovery")
        self.c_lost = r.counter(
            "spartus_sessions_lost_total",
            "sessions a watchdog recovery could not salvage")
        self.c_checkpoints = r.counter(
            "spartus_checkpoints_total", "pool checkpoints written")
        self.c_restored = r.counter(
            "spartus_sessions_restored_total",
            "sessions restored from a checkpoint")
        self.h_restore = r.histogram(
            "spartus_restore_seconds",
            "checkpoint snapshot / restore wall time")
        self.h_handoff = r.histogram(
            "spartus_tick_handoff_seconds",
            "async tick: submit to worker start plus worker end to loop "
            "resume", buckets=HANDOFF_BUCKETS)
        self._fault_counters: Dict[str, Counter] = {}
        # the launch counters: last fetched [L, 6] totals and the
        # per-layer registry counters, made on first sight
        self._last_kernel_counts: Optional[np.ndarray] = None
        self._kernel_counters: Dict[Tuple[int, str], List[Counter]] = {}
        # boundary-fold state: the previous boundary's (not-yet-fetched)
        # telemetry totals and the last fetched values for diffing.
        self._chunk_seq = 0
        self._pending_totals: Optional[Any] = None   # device [3] array
        self._last_totals = np.zeros((3,), np.float64)
        self._shard_gauges: Dict[int, Gauge] = {}

    # -- source hooks (host-side bookkeeping the pool already does) ---------

    def fold_admissions(self, n: int) -> None:
        if n:
            self.c_admissions.inc(n)

    def fold_results(self, results: Sequence[Any]) -> None:
        """Count delivered RequestResults (complete vs truncated)."""
        n_trunc = sum(1 for r in results if getattr(r, "truncated", False))
        if n_trunc:
            self.c_truncated.inc(n_trunc)
        if len(results) - n_trunc:
            self.c_completed.inc(len(results) - n_trunc)

    def fold_cancelled(self, n: int) -> None:
        if n:
            self.c_cancelled.inc(n)

    def fold_slot_bytes(self, per_slot: float) -> None:
        """Record the pool's per-slot device footprint (host shape
        arithmetic from ``SessionPool.bytes_per_slot`` — no device sync)."""
        self.g_slot_bytes.set(float(per_slot))

    # -- robustness-layer hooks (serving/faults.py, serving/checkpoint.py,
    #    the async watchdog / reaper / shed paths) --------------------------

    def fold_fault(self, site: str) -> None:
        """Count one observed fault at ``site`` (labelled counter,
        get-or-create like the per-shard load gauges)."""
        c = self._fault_counters.get(site)
        if c is None:
            c = self.registry.counter(
                "spartus_faults_total", "faults observed, by site",
                labels={"site": site})
            self._fault_counters[site] = c
        c.inc()

    def fold_shed(self) -> None:
        self.c_shed.inc()

    def fold_timeouts(self, n: int) -> None:
        if n:
            self.c_timeouts.inc(n)

    def fold_bad_request(self) -> None:
        self.c_bad_requests.inc()

    def fold_checkpoint(self, *, n_sessions: int, seconds: float) -> None:
        self.c_checkpoints.inc()
        self.h_restore.observe(seconds)

    def fold_restore(self, *, n_sessions: int, seconds: float) -> None:
        if n_sessions:
            self.c_restored.inc(n_sessions)
        self.h_restore.observe(seconds)

    def fold_recovery(self, *, salvaged: int, lost: int,
                      seconds: float) -> None:
        """One watchdog recovery: pool rebuilt, ``salvaged`` sessions
        restored, ``lost`` sessions failed with a retriable error."""
        self.c_recoveries.inc()
        if salvaged:
            self.c_salvaged.inc(salvaged)
        if lost:
            self.c_lost.inc(lost)
        self.h_restore.observe(seconds)

    # -- the per-boundary fold ----------------------------------------------

    def _diff_totals(self, new_totals: Optional[Any]
                     ) -> Tuple[Tuple[float, float, float], Dict[str, int]]:
        """Resolve the PREVIOUS boundary's enqueued telemetry totals (its
        chunk has since completed, so this fetch does not sync on the
        in-flight dispatch), diff against the running values, and enqueue
        ``new_totals`` for the next boundary.  Returns the window's
        (temporal_sparsity, overflow_rate, steps) and its launch-counter
        increments (`_diff_kernels`): a source whose ``kernel_counts()``
        gives the engines' ``[L, 6]`` totals, staged in the same copy,
        brings them along."""
        inc = (0.0, 0.0, 0.0)
        kinc = {f"{k}_{f}_inc": 0 for k in KERNELS for f in KERNEL_FIELDS}
        kinc.update({f"{CLIP}_{f}_inc": 0 for f in CLIP_FIELDS})
        pend = self._pending_totals
        if pend is not None:
            now = _host_values(pend)
            d = now - self._last_totals
            self._last_totals = now
            d_steps = d[2]
            if d_steps > 0:
                inc = (float(1.0 - d[0] / d_steps),
                       float(d[1] / d_steps), float(d_steps))
            counts = getattr(pend, "kernel_counts", None)
            if counts is not None:
                self._diff_kernels(counts(), pend.kernels, kinc)
        self._pending_totals = new_totals
        return inc, kinc

    def _diff_kernels(self, now: Optional[np.ndarray],
                      kernels: Sequence[str], inc: Dict[str, int]) -> None:
        """Fold fetched launch-counter totals ``now [L, 6]`` (layer l's
        product is ``kernels[l]``, its last two columns the capacity
        clip's): the per-layer registry counters grow by the increments,
        and ``inc`` gets them summed over layers."""
        if now is None:
            return
        now = np.asarray(now, np.int64)
        last = self._last_kernel_counts
        # totals below the last ones: a new pool's counters (recovery)
        restart = (last is None or last.shape != now.shape
                   or bool((now < last).any()))
        d = now if restart else now - last
        self._last_kernel_counts = now
        for layer, kernel in enumerate(kernels):
            # columns: the product's FIELDS, then the clip's CLIP_FIELDS
            for name, fields, col, what in (
                    (kernel, KERNEL_FIELDS, 0, "the pool's sparse products"),
                    (CLIP, CLIP_FIELDS, len(KERNEL_FIELDS),
                     "the dense route's capacity clip")):
                key = (layer, name)
                counters = self._kernel_counters.get(key)
                if counters is None:
                    counters = self._kernel_counters[key] = [
                        self.registry.counter(
                            f"spartus_kernel_{field}_total",
                            f"launch counters of {what}: {field}",
                            labels={"kernel": name, "layer": str(layer)})
                        for field in fields]
                for i, (field, c) in enumerate(zip(fields, counters)):
                    n = int(d[layer, col + i])
                    if n > 0:
                        c.inc(n)
                        inc[f"{name}_{field}_inc"] += n

    def fold_chunk(
        self, *,
        occupancy: int,
        capacity: int,
        n_active: int,
        frames_advanced: int,
        dispatch_s: float,
        chunk_s: float,
        host_overlap_frac: float,
        admissions: int,
        retirements: int,
        shard_loads: Optional[Sequence[int]] = None,
        telemetry_totals: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """Fold one dispatch boundary into counters, gauges and the time
        series.  Every argument is a host value the pool computed anyway;
        ``telemetry_totals`` is the (device, un-fetched) [3] reduction of
        the `[L, B]` accumulators after this chunk, with the engines'
        launch counters when they count — it is only *fetched* at the
        next boundary.  Returns the appended sample (the async
        driver amends it with loop-side fields via
        ``timeseries.update_last``)."""
        self._chunk_seq += 1
        t_mono = time.perf_counter()
        (sp_inc, ovf_inc, steps_inc), kernel_inc = self._diff_totals(
            telemetry_totals)
        self.c_dispatches.inc()
        self.c_frames.inc(frames_advanced)
        self.g_occupancy.set(occupancy)
        self.g_active_frac.set(n_active / capacity if capacity else 0.0)
        self.g_overlap.set(host_overlap_frac)
        if steps_inc > 0:
            self.g_sparsity.set(sp_inc)
        self.h_dispatch.observe(dispatch_s)
        self.h_chunk.observe(chunk_s)
        self.h_advance.observe(frames_advanced)
        if shard_loads is not None:
            for i, load in enumerate(shard_loads):
                g = self._shard_gauges.get(i)
                if g is None:
                    g = self.registry.gauge(
                        "spartus_shard_load", "occupied slots per shard",
                        labels={"shard": str(i)})
                    self._shard_gauges[i] = g
                g.set(load)
        dropped_before = self.timeseries.n_dropped
        sample: Dict[str, Any] = {
            "chunk": self._chunk_seq,
            "t_wall": time.time(),
            "t_mono": t_mono,
            "occupancy": occupancy,
            "active_frac": n_active / capacity if capacity else 0.0,
            "frames": frames_advanced,
            "dispatch_s": dispatch_s,
            "chunk_s": chunk_s,
            "host_overlap_frac": host_overlap_frac,
            "admissions": admissions,
            "retirements": retirements,
            "shard_loads": list(shard_loads) if shard_loads is not None
            else [occupancy],
            "lagging": 0,
            "partial_queue_depth_max": 0,
            # incremental sparsity of the PREVIOUS window (one-boundary
            # lag: its totals were fetched here, never syncing the
            # in-flight chunk):
            "temporal_sparsity_inc": sp_inc,
            "overflow_rate_inc": ovf_inc,
            "samples_inc": steps_inc,
            # the async server's thread hand-off for this tick, amended
            # after the tick returns (0.0 where the tick ran inline)
            "handoff_s": 0.0,
            # launch counters of the same (previous) window, per kernel
            # summed over layers and shards: <kernel>_<field>_inc
            **kernel_inc,
        }
        self.timeseries.append(sample)
        if self.timeseries.n_dropped > dropped_before:
            self.c_ts_dropped.inc(self.timeseries.n_dropped - dropped_before)
        return sample

    def flush_totals(self) -> None:
        """Resolve any still-pending telemetry totals (end of run), so
        the final sample-diff state is consistent with
        `measured_sparsity`."""
        self._diff_totals(None)
