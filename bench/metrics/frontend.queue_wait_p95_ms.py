"""95th percentile of ``RequestResult.queue_wait_s`` (stream opened to
slot bound) of the finished streams admitted in the window's middle
third."""
from bench.readers import in_clean, percentile_ms


def read(rec):
    waits = [w for at, w in rec.get("queue_waits", ()) if in_clean(rec, at)]
    return percentile_ms(waits, 95)
