"""Host time of the pool's ``slot_bookkeeping`` spans (its walks over
the slots and its retirement steps, on the tick's thread) over the frame
steps dispatched (a chunk of n frames is n steps), in the window's middle
third: the base of ``pool.dispatch_us_per_step``."""
from bench.readers import in_clean, span_durations


def read(rec):
    d = span_durations(rec, "slot_bookkeeping")
    steps = sum(n for t, n in rec.get("chunks", ()) if in_clean(rec, t))
    return 1e6 * sum(d) / steps if d and steps else None
