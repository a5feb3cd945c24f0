"""The dense-mirror kernel's share of its roofline, in percent: the
least time its calls' inputs need (mirror rows of the union of fired
columns, the deltas and the outputs at HBM's 3.35 TB/s, or 2 x fired x N
operations at 67 TFLOP/s, whichever is longer) over its device time."""
from bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "dense_mirror", "dense_mirror_kernel")
