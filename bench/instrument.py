"""What the traced run (``--trace 1``) records, and nothing the
untraced run pays for.

The window is cut in thirds.  In the first, ``Counters`` wrap the
port's ``kernels/ops.py`` entry points and accumulate on the device,
read once at the end: each dense-mirror and CBCSC SpMV call's bytes,
operations and least time (``counting.py``), the fired deltas of every
layer-step by the width of the encoder call's input, and the active
rows.  The second runs as an untraced run does but for the host spans,
which come from the program's tracer sites (``SpanRecorder`` is handed
to ``PoolObservability``) and from the harness's own: host times and
rates are read there.  In the last,
torch.profiler records the device (``DeviceProfile``: kernels, copies,
their times) and no counter runs, so launches and device times are the
program's own; its tracing slows the host, so no host time is read
there.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from bench import counting


class _Span:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.spans.append((self._name, self._t0, time.perf_counter()))


class SpanRecorder:
    """A tracer for the program's span sites: ``(name, t0, t1)`` on the
    host clock (``time.perf_counter``), kept in memory."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []

    def span(self, name: str) -> _Span:
        return _Span(self, name)


class NullHooks:
    """The untraced run's window marks: times only.  ``t0`` opens the
    window, ``ta`` and ``tb`` are its thirds, ``t1`` closes it."""

    t0 = ta = tb = t1 = None

    def window_start(self, t: float) -> None:
        self.t0 = t

    def segment(self, k: int, t: float) -> None:
        if k == 1:
            self.ta = t
        else:
            self.tb = t

    def end_due(self, seconds: float) -> float:
        """When the window closes."""
        return self.t0 + seconds

    def retry_profile(self) -> bool:
        """Whether the window's last third has to be profiled again."""
        return False

    def window_end(self, t: float) -> None:
        self.t1 = t


class TracedHooks(NullHooks):
    """Counters run in the first third, nothing but the spans in the
    second, the device profile in the last."""

    def __init__(self, counters: "Counters",
                 profile: Optional["DeviceProfile"]):
        self.counters, self.profile = counters, profile

    def window_start(self, t: float) -> None:
        super().window_start(t)
        self.counters.active = True

    def segment(self, k: int, t: float) -> None:
        if k == 1:
            self.counters.active = False
        super().segment(k, time.perf_counter())
        if k == 2 and self.profile is not None:
            self.profile.activate()

    def end_due(self, seconds: float) -> float:
        """A third of the window after the profiler came up: its start
        can stall the host, and that falls outside every third."""
        if self.profile is None:
            return super().end_due(seconds)
        return self.profile.t_on + seconds / 3

    def window_end(self, t: float) -> None:
        if self.profile is not None:
            self.profile.finish()
        super().window_end(time.perf_counter())

    def retry_profile(self) -> bool:
        """CUPTI now and then drops a session's device events (on an
        H100, one traced run in 24 kept 0.7% of its busy time): such a
        profile is taken once more, over another third, under the same
        load."""
        if self.profile is None or self.profile.complete() or \
                getattr(self, "_retried", False):
            return False
        self._retried = True
        self.profile.activate()
        return True


class Counters:
    """Device accumulators behind wrappers of the port's ops entry
    points; they count only while ``active``.  An encoder call whose
    input ``x`` is ``row_width`` wide starts a row (the model family's
    ``row_width``); fired deltas are kept by the width of ``x``, so a
    family can weigh each sparse product's at its own cost."""

    def __init__(self, ops, row_width: int, device):
        import torch

        self.torch = torch
        self.ops = ops
        self.row_width = row_width
        self.device = device
        self.active = False
        self.acc = {name: torch.zeros(4, dtype=torch.float64, device=device)
                    for name in ("dense_mirror", "stsp_spmv")}
        self.rows = torch.zeros((), dtype=torch.float64, device=device)
        self.fired: Dict[int, object] = {}
        self._orig = {}

    def install(self) -> None:
        ops = self.ops
        self._orig = {"_mirror_matmul": ops._mirror_matmul,
                      "stsp_spmv_batch": ops.stsp_spmv_batch,
                      "delta_encode_step": ops.delta_encode_step}
        orig = dict(self._orig)
        torch = self.torch

        def mirror(ds, wt, scale=None):
            y = orig["_mirror_matmul"](ds, wt, scale)
            if self.active:
                fired = ds != 0
                b, q = ds.shape
                nb, nops = counting.dense_mirror_call(
                    fired.any(0).sum().double(), fired.sum().double(), b, q,
                    wt.shape[1], wt.element_size())
                self._add("dense_mirror", nb, nops)
            return y

        def spmv(val, lidx, idx, ds_vals, *, s, scale=None):
            y = orig["stsp_spmv_batch"](val, lidx, idx, ds_vals, s=s,
                                        scale=scale)
            if self.active:
                q, m, blen = val.shape
                b, k = idx.shape
                fired = (ds_vals != 0).to(torch.float32)
                mark = torch.zeros(q, dtype=torch.float32, device=val.device)
                mark.scatter_reduce_(0, idx.reshape(-1).long(),
                                     fired.reshape(-1), reduce="amax")
                nb, nops = counting.stsp_spmv_call(
                    mark.sum().double(), fired.sum().double(), b, k, m,
                    blen, val.element_size(), lidx.element_size(), s * m)
                self._add("stsp_spmv", nb, nops)
            return y

        def encode(x, h, s_hat, theta, *, active=None, **kw):
            delta, nnz = orig["delta_encode_step"](x, h, s_hat, theta,
                                                   active=active, **kw)
            if self.active:
                act = (torch.ones_like(nnz, dtype=torch.float64)
                       if active is None else active.to(torch.float64))
                width = x.shape[-1]
                acc = self.fired.get(width)
                if acc is None:
                    acc = self.fired[width] = torch.zeros(
                        (), dtype=torch.float64, device=self.device)
                acc.add_((nnz.to(torch.float64) * act).sum())
                if width == self.row_width:
                    self.rows.add_(act.sum())
            return delta, nnz

        ops._mirror_matmul = mirror
        ops.stsp_spmv_batch = spmv
        ops.delta_encode_step = encode

    def _add(self, name, n_bytes, ops):
        torch = self.torch
        one = torch.ones((), dtype=torch.float64, device=n_bytes.device)
        self.acc[name].add_(torch.stack(
            [n_bytes, ops, counting.bound_s(n_bytes, ops), one]))

    def uninstall(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)

    def read(self) -> Dict[str, Dict]:
        """Per kernel its bytes, operations, least time and calls; under
        ``fired`` the active rows and the fired deltas by the width of
        the encoder call's input (``by_width``)."""
        out = {}
        for name, t in self.acc.items():
            v = [float(x) for x in t.cpu()]
            out[name] = {"bytes": v[0], "ops": v[1], "bound_s": v[2],
                         "calls": v[3]}
        out["fired"] = {"rows": float(self.rows), "by_width": {
            w: float(t) for w, t in sorted(self.fired.items())}}
        return out


class DeviceProfile:
    """torch.profiler on the device's activity only, over the window's
    last third: ``activate`` starts it (its start-up stall falls before
    the recorded span), ``finish`` stops it and keeps, per device op
    (kernels, copies, sets), its name, start and duration on the host
    clock."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []
        self.t_on = self.t_off = None
        self._prof = None

    def prepare(self) -> None:
        """One empty session during set-up: the tracer's first start
        initialises CUPTI, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def complete(self) -> bool:
        """Whether the layer-steps' HPE kernel is among the ops: every
        served step launches it, so a profile without it lost events."""
        return any("lstm_pointwise_kernel" in name for name, _, _ in self.ops)

    def activate(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.ops = []
        t = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        # kineto stamps events on the epoch clock; spans use perf_counter
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t_on = time.perf_counter()
        self.start_stall_s = self.t_on - t

    def finish(self) -> None:
        from torch.autograd import DeviceType

        self.t_off = time.perf_counter()
        self._prof.stop()
        off = self._offset_ns
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            self.ops.append((e.name(), (e.start_ns() - off) * 1e-9,
                             e.duration_ns() * 1e-9))
        self._prof = None

    def summary(self) -> dict:
        """Per-name counts and seconds, launches, busy seconds (the union
        of the ops' intervals) and the recorded window's length."""
        kernels: Dict[str, List[float]] = {}
        for name, _, dur in self.ops:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += dur
        return {"kernels": kernels, "launches": len(self.ops),
                "busy_s": sum(b - a for a, b in busy_intervals(self.ops)),
                "window_s": self.t_off - self.t_on,
                "t_on": self.t_on, "t_off": self.t_off, "ops": self.ops,
                "start_stall_s": self.start_stall_s}


def busy_intervals(ops) -> List[Tuple[float, float]]:
    """The union of ``(name, start, duration)`` intervals, sorted."""
    return _union([(a, a + d) for _, a, d in ops])


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        else:
            out.append((a, b))
    return out


def _overlap(xs, ys) -> float:
    """Measure of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(ops, spans, t_on: float, t_off: float
                 ) -> List[Tuple[str, float]]:
    """Device idle time in ``[t_on, t_off]`` by the host span that covers
    it (a gap under spans of two threads counts for both; what no span
    covers is ``(no span)``), longest first."""
    busy = busy_intervals(ops)
    gaps, at = [], t_on
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, t_off)))
        at = max(at, b)
        if at >= t_off:
            break
    if at < t_off:
        gaps.append((at, t_off))
    gaps = [(a, b) for a, b in gaps if b > a]
    by_name: Dict[str, list] = {}
    for name, a, b in spans:
        if b > t_on and a < t_off:
            by_name.setdefault(name, []).append((a, b))
    out = [(name, _overlap(gaps, _union(iv))) for name, iv in by_name.items()]
    covered = _overlap(gaps, _union([iv for ivs in by_name.values()
                                     for iv in ivs]))
    out.append(("(no span)", sum(b - a for a, b in gaps) - covered))
    return sorted(out, key=lambda r: -r[1])


class ChunkLog:
    """``(t, n_frames)`` of every pool chunk dispatched: the frame steps
    the dispatch spans paid for."""

    def __init__(self, engine_cls):
        self.cls = engine_cls
        self.calls: List[Tuple[float, int]] = []
        self._orig = None

    def install(self) -> None:
        self._orig = orig = self.cls.step_chunk
        calls = self.calls

        def step_chunk(eng, *args, n_frames, **kw):
            calls.append((time.perf_counter(), int(n_frames)))
            return orig(eng, *args, n_frames=n_frames, **kw)

        self.cls.step_chunk = step_chunk

    def uninstall(self) -> None:
        if self._orig is not None:
            self.cls.step_chunk = self._orig
