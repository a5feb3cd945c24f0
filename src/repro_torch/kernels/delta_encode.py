"""Fused delta encoding (the Spartus DPE, Fig. 6) — CUDA port of
``repro/kernels/delta_encode.py:delta_encode_pallas``.

Eqs. (4)-(5) for a whole pool in one launch: thresholded delta,
reference-state update and per-slot fired counts
(``csrc/spartus_kernels.cu:delta_encode_kernel``).  ``delta_encode_step``
is the IPU stage of one layer-step: it reads the layer input and the
previous hidden state through two pointers (no concatenation) and updates
the reference state in place for the active slots.  ``delta_encode``, the
reference's call shape, runs the same kernel with the whole row as x and
a separate output.  A CPU tensor runs the plain version (``ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.analysis import hlo
from repro_torch.kernels import _build, ref

KERNEL = _build.Kernel("delta_encode")
plain = ref.delta_encode_ref
plain_step = ref.delta_encode_step_ref

_F32 = torch.float32
_DTYPES = {"x": _F32, "h": _F32, "s_hat": _F32, "s_hat_out": _F32,
           "active": torch.bool}


@functools.lru_cache(maxsize=256)
def _threshold_args(theta: float, act_bits: Optional[int],
                    act_frac_bits: int) -> Tuple:
    """(theta, quantize, scale, qmin, qmax) as the kernel takes them,
    cached: ``ref.snap_theta`` builds a tensor, too slow for every
    launch."""
    snapped = ref.snap_theta(theta, act_bits, act_frac_bits)
    if act_bits is None:
        return snapped, 0, 1.0, 0.0, 0.0
    qmax = 2.0 ** (act_bits - 1) - 1
    return snapped, 1, 2.0 ** (-act_frac_bits), -qmax - 1, qmax


def _launch(x: torch.Tensor, h: Optional[torch.Tensor], s_hat: torch.Tensor,
            active: Optional[torch.Tensor], s_hat_out: torch.Tensor,
            theta: float, act_bits: Optional[int], act_frac_bits: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    device = _build.check_cuda("delta_encode", _DTYPES, x=x, h=h,
                               s_hat=s_hat, active=active,
                               s_hat_out=s_hat_out)
    b, d = x.shape if x.dim() == 2 else (-1, -1)
    hidden = 0 if h is None else h.shape[-1]
    if (d < 0 or (h is not None and h.shape != (b, hidden))
            or s_hat.shape != (b, d + hidden)
            or (active is not None and active.shape != (b,))):
        raise ValueError(
            f"delta_encode: expected x [B, D], h [B, H], s_hat [B, D+H] and "
            f"active [B], got {tuple(x.shape)}, "
            f"{None if h is None else tuple(h.shape)}, {tuple(s_hat.shape)} "
            f"and {None if active is None else tuple(active.shape)}")
    delta = torch.empty_like(s_hat)
    nnz = torch.empty((b,), dtype=torch.int32, device=device)
    KERNEL.launch("spartus_delta_encode_step", device, x, h, s_hat, active,
                  delta, s_hat_out, nnz, b, d, hidden,
                  *_threshold_args(float(theta), act_bits, act_frac_bits))
    return delta, nnz


@hlo.kernel_region("delta_encode")
def delta_encode(
    x: torch.Tensor, x_hat: torch.Tensor, theta: float,
    act_bits: Optional[int] = None, act_frac_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, x_hat [B, F] float32 -> (delta [B, F], new_x_hat [B, F],
    nnz [B] int32).  ``act_bits`` runs the comparison on the Qm.n grid."""
    if x.device.type == "cpu":
        return plain(x, x_hat, theta, act_bits, act_frac_bits)
    new_x_hat = torch.empty_like(x_hat)
    delta, nnz = _launch(x, None, x_hat, None, new_x_hat, theta, act_bits,
                         act_frac_bits)
    return delta, new_x_hat, nnz


@hlo.kernel_region("delta_encode")
def delta_encode_step(
    x: torch.Tensor, h: torch.Tensor, s_hat: torch.Tensor, theta: float,
    active: Optional[torch.Tensor] = None, act_bits: Optional[int] = None,
    act_frac_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IPU stage of one layer-step on s = [x | h] (x [B, D], h
    [B, H]): s_hat [B, D+H] is updated in place for the rows ``active
    [B]`` (bool) selects, all rows if None.  Returns (delta [B, D+H],
    nnz [B] int32), both for every row."""
    if x.device.type == "cpu":
        return plain_step(x, h, s_hat, theta, active, act_bits,
                          act_frac_bits)
    return _launch(x, h, s_hat, active, s_hat, theta, act_bits,
                   act_frac_bits)
