"""The dense-mirror SpMV's product, batch-invariant — a CUDA kernel of
the port's own (``csrc/spartus_kernels.cu:dense_mirror_kernel``), not the
port of a Pallas kernel: it stands in for the XLA dot of
``repro/kernels/ops.py:delta_spmv_dense_topk_batch``.

    y[b, j] = float32( sum_k float64(ds[b, k]) * float64(wt[k, j]) )

then ``y * scale`` for an int8 mirror.  The mirror stays at its packed
dtype (float32 or int8) and is widened in registers; the order of every
row's sum is a function of Q alone, so a session's row does not depend
on the pool it shares (cuBLAS's fp32 GEMM picks another reduction order
for 1 row than for 16, which the recurrence amplifies).  A CPU tensor
runs the plain version (``ref.dense_mirror_ref``, a float64 matmul); a
CUDA tensor launches the kernel or raises.  With a layer's launch
counters selected (``kernels/counters.py``) the call also counts itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis import hlo
from repro_torch.kernels import _build, counters, ref

KERNEL = _build.Kernel("dense_mirror")
plain = ref.dense_mirror_ref

_TAGS = {torch.float32: "f32", torch.int8: "i8"}
_DTYPES = {"ds": torch.float32, "scale": torch.float32}


@hlo.kernel_region("dense_mirror")
def dense_mirror(ds: torch.Tensor, wt: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ds [B, Q] float32, wt [Q, N] float32 or int8, scale a 1-element
    float32 tensor or None -> y [B, N] float32."""
    layer = counters.selected.layer
    if ds.device.type == "cpu":
        y = plain(ds, wt, scale)
        if layer is not None and ds.shape[0] and wt.shape[1]:
            counters.count_mirror_plain(layer, ds)
        return y
    device = _build.check_cuda("dense_mirror", _DTYPES, ds=ds, wt=wt,
                               scale=scale)
    if wt.dtype not in _TAGS:
        raise TypeError(f"dense_mirror: wt must be float32 or int8, got "
                        f"{wt.dtype}")
    if (ds.dim() != 2 or wt.dim() != 2 or ds.shape[1] != wt.shape[0]
            or (scale is not None and scale.numel() != 1)):
        raise ValueError(
            f"dense_mirror: expected ds [B, Q], wt [Q, N] and a 1-element "
            f"scale, got {tuple(ds.shape)}, {tuple(wt.shape)} and "
            f"{None if scale is None else tuple(scale.shape)}")
    b, q = ds.shape
    n = wt.shape[1]
    y = torch.empty((b, n), dtype=torch.float32, device=device)
    KERNEL.launch(f"spartus_dense_mirror_{_TAGS[wt.dtype]}", device, ds, wt,
                  scale, y, b, q, n, *counters.pointers(layer))
    return y
