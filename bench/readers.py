"""Shared arithmetic of the metric readers (``bench/metrics/*.py``).

A reader gets the run's record: the window's marks ``t0`` (open), ``ta``
and ``tb`` (its thirds) and ``t1`` (close) on the host clock, what the
clients held, the spans, and in a traced run the first third's device
counters (``counts``) and the last third's device profile
(``profile``); host times are read in the middle third, which runs
with neither (``instrument.py``)."""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np


def in_clean(rec, t: float) -> bool:
    """Whether ``t`` falls in the middle third of a traced window."""
    return rec["ta"] <= t < rec["tb"]


def span_durations(rec, name: str) -> List[float]:
    """Durations of the spans called ``name`` that start in the middle
    third of the window."""
    return [b - a for n, a, b in rec["spans"]
            if n == name and in_clean(rec, a)]


def kernel_totals(rec, patterns: Iterable[str]):
    """(launches, device seconds) of the profiled ops whose name holds
    any of ``patterns`` (case-insensitive); None without a profile."""
    prof = rec.get("profile")
    if not prof:
        return None
    pats = [p.lower() for p in patterns]
    n, sec = 0, 0.0
    for name, (count, seconds) in prof["kernels"].items():
        low = name.lower()
        if any(p in low for p in pats):
            n += count
            sec += seconds
    return n, sec


def layer_frames(rec) -> Optional[int]:
    """Layer-steps in the profile: one HPE launch each, whatever the
    engine."""
    got = kernel_totals(rec, ["lstm_pointwise_kernel"])
    return got[0] if got and got[0] else None


def percentile_ms(values, q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q)) * 1e3


def roofline_pct(rec, counter: str, kernel: str) -> Optional[float]:
    """Least time per call over device time per launch, in percent: the
    first third's counted calls against the last third's profiled
    launches of the same kernel."""
    counts = rec.get("counts") or {}
    c = counts.get(counter)
    got = kernel_totals(rec, [kernel])
    if not c or not c["calls"] or not got or not got[0] or not got[1]:
        return None
    return 100.0 * (c["bound_s"] / c["calls"]) / (got[1] / got[0])
