"""Mean length of the async server's ``delivery_pump`` span (one per
tick: partials and results onto the clients' queues)."""
from bench.readers import span_durations


def read(rec):
    d = span_durations(rec, "delivery_pump")
    return 1e3 * sum(d) / len(d) if d else None
