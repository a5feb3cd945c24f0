"""Logit rows the clients held inside the window, over its length."""


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    rows = sum(n for t, n in rec.get("deliveries", ()) if t0 <= t < t1)
    return rows / (t1 - t0) if rows else None
