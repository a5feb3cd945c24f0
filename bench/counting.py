"""Operations and bytes of the served kernels, and the chip's peaks.

Each call's counts are what its inputs need, not what the kernel reads:
a weight row (dense mirror) or CBCSC column (scatter SpMV) is read once
for the union of the columns fired in any row of the launch, the deltas
or NZI lists and the outputs once each.  Operations are two per
multiply-add the kernel has to make: ``fired x outputs`` a row, where a
fired column's outputs are the mirror's N (dense) or its M x BLEN kept
weights (CBCSC).  The functions take Python numbers or device tensors,
so the traced run accumulates them on the device.
"""
from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at 700 W
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
}


def dense_mirror_call(union, nnz, b, q, n, w_bytes):
    """``ds [b, q] @ wt [q, n]``: (bytes, ops).  ``union`` columns of
    ``ds`` fired in some row, ``nnz`` fired entries in all rows."""
    n_bytes = union * n * w_bytes + b * q * 4 + b * n * 4
    return n_bytes, 2 * nnz * n


def stsp_spmv_call(union, nnz, b, k, m, blen, val_bytes, lidx_bytes,
                   out_rows):
    """CBCSC SpMV of ``b`` NZI lists of capacity ``k`` over columns of
    ``m x blen`` (value, index) pairs into ``b x out_rows`` outputs."""
    n_bytes = (union * m * blen * (val_bytes + lidx_bytes)
               + b * k * (4 + 4) + b * out_rows * 4)
    return n_bytes, 2 * nnz * m * blen


def bound_s(n_bytes, ops, peaks=PEAKS):
    """The least time the chip could take: the larger of the byte time
    at HBM's rate and the operation time at the fp32 rate."""
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    t_ops = ops / peaks["fp32_flops_per_s"]
    if hasattr(t_bytes, "maximum"):
        return t_bytes.maximum(t_ops)
    return max(t_bytes, t_ops)


def kept_per_column(rows: int, gamma: float, m: int) -> int:
    """Weights CBTD keeps in one column of a stack of ``rows`` rows: M
    subcolumns of ``S - floor(S gamma)``, ``S = rows / M``."""
    s = rows // m
    return m * (s - int(s * gamma))
