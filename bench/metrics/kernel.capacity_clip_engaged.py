"""The share of the rows the dense route's capacity clip saw that it
clipped (more deltas fired than the capacity), in percent: the program's
clip counters summed over the window's boundary samples.  A program
without them leaves the metric out."""
from bench.samples import boundary_samples


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    rows = clipped = 0
    for s in boundary_samples(rec):
        if "capacity_clip_rows_inc" in s and t0 <= s.get("t_mono", -1) < t1:
            rows += s["capacity_clip_rows_inc"]
            clipped += s["capacity_clip_clipped_inc"]
    return 100.0 * clipped / rows if rows else None
