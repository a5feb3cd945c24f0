"""95th percentile over every block due in the window of (client holds
the block's last logit row) - (block due on the schedule)."""
from bench.readers import percentile_ms


def read(rec):
    return percentile_ms(rec.get("latencies"), 95)
