"""Mean thread hand-off of the async server's offloaded tick, in
microseconds: (worker start - submit) + (loop resume - worker end), the
program's ``handoff_s`` of each boundary sample stamped (``t_mono``) in
the window's middle third."""
from bench.readers import in_clean
from bench.samples import boundary_samples


def read(rec):
    got = [s["handoff_s"] for s in boundary_samples(rec)
           if "handoff_s" in s and "t_mono" in s
           and in_clean(rec, s["t_mono"])]
    return 1e6 * sum(got) / len(got) if got else None
