"""The dense route's fired count and capacity clip in one launch — a CUDA
kernel of the port's own (``csrc/spartus_kernels.cu:
capacity_clip_topk_kernel``), not the port of a Pallas kernel: it stands
in for the count and the ``lax.cond``-guarded clip of
``repro/kernels/ops.py:delta_spmv_dense_topk_batch``.

    n_dropped[b] = max(#{q : delta[b, q] != 0} - capacity, 0)
    ds[b]        = delta[b] but its k = min(capacity, Q) largest |delta|
                   zeroed, ties at the k-th kept toward the lower index
                   (the kept set of ``ops.select_active_columns``)

and for k >= Q, ds is delta itself.  The reference clips only when some
row overflowed; the plain version below, the chain the port ran before,
clips every time (a branch on a device value would sync the host), and
the kernel takes that branch per row on the device: a row with at most k
fired entries is written through.  Both give the chain's bits.  A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  With a layer's launch counters selected (``kernels/counters.py``)
the call also counts the rows it saw and the rows it clipped.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.analysis import hlo
from repro_torch.kernels import _build, counters

KERNEL = _build.Kernel("capacity_clip")

_DTYPES = {"delta": torch.float32}


def _clip_to_capacity(delta: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest |delta| per row, boundary ties kept
    toward the lower index (the kept set of ``select_active_columns``).
    The identity on rows with at most k fired entries."""
    fired = delta != 0
    mag = delta.abs()
    masked = torch.where(fired, mag, torch.full_like(mag, -1.0))
    thresh = torch.topk(masked, k, dim=-1).values[..., -1:]   # k-th largest
    above = fired & (mag > thresh)
    ties = fired & (mag == thresh)
    n_above = above.sum(-1, keepdim=True, dtype=torch.int32)
    tie_rank = torch.cumsum(ties.to(torch.int32), dim=-1)
    keep = above | (ties & (tie_rank <= k - n_above))
    return torch.where(keep, delta, torch.zeros_like(delta))


def plain(delta: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: delta [B, Q] -> (ds [B, Q], n_dropped [B]
    int32), in PyTorch."""
    q = delta.shape[-1]
    k = min(capacity, q)
    n_fired = (delta != 0).sum(-1, dtype=torch.int32)
    n_dropped = torch.clamp(n_fired - capacity, min=0)
    ds = delta if k >= q else _clip_to_capacity(delta, k)
    return ds, n_dropped


@hlo.kernel_region("capacity_clip")
def capacity_clip(delta: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta [B, Q] float32, capacity >= 1 -> (ds [B, Q] float32,
    n_dropped [B] int32)."""
    layer = counters.selected.layer
    if delta.device.type == "cpu":
        ds, n_dropped = plain(delta, capacity)
        if layer is not None:
            counters.count_clip_plain(layer, n_dropped)
        return ds, n_dropped
    device = _build.check_cuda("capacity_clip", _DTYPES, delta=delta)
    if delta.dim() != 2 or capacity < 1:
        raise ValueError(f"capacity_clip: expected delta [B, Q] and a "
                         f"capacity >= 1, got {tuple(delta.shape)} and "
                         f"{capacity}")
    b, q = delta.shape
    n_dropped = torch.empty((b,), dtype=torch.int32, device=device)
    ds = delta if capacity >= q else torch.empty_like(delta)
    KERNEL.launch("spartus_capacity_clip_topk", device, delta,
                  None if ds is delta else ds, n_dropped, b, q, capacity,
                  None if layer is None else layer.clip)
    return ds, n_dropped
