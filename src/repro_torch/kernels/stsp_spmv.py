"""Spatio-temporal sparse matrix-vector product over CBCSC weights — the
heart of the Spartus accelerator (Fig. 2/4/9); CUDA port of
``repro/kernels/stsp_spmv.py``.

    y[b, H] = sum_k ds[b, k] * W[:, idx[b, k]]

with ``W`` stored in CBCSC (``val/lidx [Q, M, BLEN]``, row r = lidx*M +
pe).  One kernel (``csrc/spartus_kernels.cu:stsp_spmv_kernel``, templated
on fp32/int8 ``val`` and int32/int8 ``lidx``) serves both Pallas kernels:

* ``stsp_spmv_scatter_batch`` replaces ``stsp_spmv_scatter_batch_pallas``
  (the pool, one launch over all slots);
* ``stsp_spmv`` replaces ``stsp_spmv_pallas`` (the batch-1 engine) by
  launching it with B = 1.  It keeps its own launch count.

A CPU tensor runs the plain versions (``ref.stsp_spmv_scatter_batch_ref``
for the pool, the one-hot spec ``ref.stsp_spmv_ref`` for batch 1); a CUDA
tensor launches the kernel or raises.  ``val`` is returned unscaled: an
int8 payload's scale is applied by the caller (``ops``).
"""
from __future__ import annotations

import torch

from repro_torch.analysis import hlo
from repro_torch.kernels import _build, ref

SCATTER_BATCH_KERNEL = _build.Kernel("stsp_spmv_scatter_batch")
KERNEL = _build.Kernel("stsp_spmv")
plain_batch = ref.stsp_spmv_scatter_batch_ref
plain = ref.stsp_spmv_ref

_TAGS = {torch.float32: "f32", torch.int8: "i8", torch.int32: "i32"}
MAX_S = 512          # 16 lanes per PE keep <= 32 rows each in registers


def _launch(kernel: _build.Kernel, val: torch.Tensor, lidx: torch.Tensor,
            idx: torch.Tensor, ds_vals: torch.Tensor, s: int) -> torch.Tensor:
    device = _build.check_cuda(
        kernel.name, {"idx": torch.int32, "ds_vals": torch.float32},
        val=val, lidx=lidx, idx=idx, ds_vals=ds_vals)
    if val.dtype not in (torch.float32, torch.int8) or lidx.dtype not in (
            torch.int32, torch.int8):
        raise TypeError(f"{kernel.name}: val must be float32/int8 and lidx "
                        f"int32/int8, got {val.dtype} and {lidx.dtype}")
    if val.dim() != 3 or lidx.shape != val.shape:
        raise ValueError(f"{kernel.name}: val and lidx must be the same "
                         f"[Q, M, BLEN], got {tuple(val.shape)} and "
                         f"{tuple(lidx.shape)}")
    if idx.dim() != 2 or ds_vals.shape != idx.shape:
        raise ValueError(f"{kernel.name}: idx and ds_vals must be the same "
                         f"[B, K], got {tuple(idx.shape)} and "
                         f"{tuple(ds_vals.shape)}")
    if s > MAX_S:
        raise ValueError(f"{kernel.name}: S={s} rows per PE exceeds the "
                         f"kernel's {MAX_S}")
    q, m, blen = val.shape
    b, k = idx.shape
    y = torch.empty((b, s * m), dtype=torch.float32, device=device)
    symbol = f"spartus_stsp_spmv_{_TAGS[val.dtype]}_{_TAGS[lidx.dtype]}"
    kernel.launch(symbol, device, val, lidx, idx, ds_vals, y, b, k, q, m,
                  blen, s)
    return y


@hlo.kernel_region("stsp_spmv_scatter_batch")
def stsp_spmv_scatter_batch(val: torch.Tensor, lidx: torch.Tensor,
                            idx: torch.Tensor, ds_vals: torch.Tensor, *,
                            s: int) -> torch.Tensor:
    """Pool SpMxSpV: idx int32 / ds_vals float32 [B, K] -> y [B, S*M]."""
    if val.device.type == "cpu":
        return plain_batch(val, lidx, idx, ds_vals, s)
    return _launch(SCATTER_BATCH_KERNEL, val, lidx, idx, ds_vals, s)


@hlo.kernel_region("stsp_spmv")
def stsp_spmv(val: torch.Tensor, lidx: torch.Tensor, idx: torch.Tensor,
              ds_vals: torch.Tensor, *, s: int) -> torch.Tensor:
    """One session: idx int32 / ds_vals float32 [K] -> y [S*M]."""
    if val.device.type == "cpu":
        return plain(val, lidx, idx, ds_vals, s)
    return _launch(KERNEL, val, lidx, idx[None], ds_vals[None], s)[0]
