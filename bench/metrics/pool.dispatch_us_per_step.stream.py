"""Host time of the pool's ``dispatch`` spans over the frame steps they
dispatched (a chunk of n frames is n steps), in the window's middle third."""
from bench.readers import in_clean, span_durations


def read(rec):
    d = span_durations(rec, "dispatch")
    steps = sum(n for t, n in rec.get("chunks", ()) if in_clean(rec, t))
    return 1e6 * sum(d) / steps if d and steps else None
