"""Performance-variant flags; port of ``repro/perf.py``.

A process-wide configuration read where a step is built: the sharding
rules (``fsdp_sp``), ``distributed.hints`` (``fsdp_sp``,
``seq_sharded_decode``) and ``launch.steps.make_serve_step``
(``int8_weights``).  ``launch/hillclimb.py`` runs a dry-run cell under a
variant and records its roofline terms beside the baseline's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class PerfVariant:
    name: str = "baseline"
    # training layout: replace TP (activation all-reduces per layer) with
    # 2-axis FSDP + sequence parallelism (per-layer weight all-gathers)
    fsdp_sp: bool = False
    # decode: keep seq-sharded KV local (distributed flash-decode combine)
    # instead of gathering the cache every step
    seq_sharded_decode: bool = True
    # serving quantization: store params / KV cache in int8
    int8_weights: bool = False
    int8_kv: bool = False
    # microbatch override (None = heuristic)
    microbatches: Optional[int] = None
    # logical mesh re-aspect for the same device count, e.g. ((32, 8),
    # ("data", "model"))
    mesh_override: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None


_CURRENT = PerfVariant()


def current() -> PerfVariant:
    return _CURRENT


@contextlib.contextmanager
def variant(v: PerfVariant):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = v
    try:
        yield
    finally:
        _CURRENT = prev
