"""The CBCSC SpMV kernel's share of its roofline, in percent: the least
time its calls' inputs need (CBCSC columns of the union of fired
columns, the NZI lists and the outputs at HBM's 3.35 TB/s, or 2 x fired
x M x BLEN operations at 67 TFLOP/s, whichever is longer) over its
device time."""
from bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "stsp_spmv", "stsp_spmv_kernel")
