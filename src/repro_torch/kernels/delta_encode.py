"""Fused delta encoding (the Spartus DPE, Fig. 6) — CUDA port of
``repro/kernels/delta_encode.py:delta_encode_pallas``.

Eqs. (4)-(5) for a whole pool in one launch: thresholded delta,
reference-state update and per-slot fired counts over ``[B, F]``
(``csrc/spartus_kernels.cu:delta_encode_kernel``).  A CPU tensor runs the
plain version ``ref.delta_encode_ref``; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

KERNEL = _build.Kernel("delta_encode")
plain = ref.delta_encode_ref


def delta_encode(
    x: torch.Tensor, x_hat: torch.Tensor, theta: float,
    act_bits: Optional[int] = None, act_frac_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, x_hat [B, F] float32 -> (delta [B, F], new_x_hat [B, F],
    nnz [B] int32).  ``act_bits`` runs the comparison on the Qm.n grid."""
    if x.device.type == "cpu":
        return plain(x, x_hat, theta, act_bits, act_frac_bits)
    f32 = torch.float32
    device = _build.check_cuda("delta_encode", {"x": f32, "x_hat": f32},
                               x=x, x_hat=x_hat)
    if x.dim() != 2 or x_hat.shape != x.shape:
        raise ValueError(f"delta_encode: x and x_hat must be the same "
                         f"[B, F], got {tuple(x.shape)} and "
                         f"{tuple(x_hat.shape)}")
    b, f = x.shape
    delta = torch.empty_like(x)
    new_x_hat = torch.empty_like(x)
    nnz = torch.empty((b,), dtype=torch.int32, device=device)
    if act_bits is None:
        quantize, scale, qmin, qmax = 0, 1.0, 0.0, 0.0
    else:
        quantize, scale = 1, 2.0 ** (-act_frac_bits)
        qmax = 2.0 ** (act_bits - 1) - 1
        qmin = -qmax - 1
    KERNEL.launch("spartus_delta_encode", device, x, x_hat, delta, new_x_hat,
                  nnz, b, f, ref.snap_theta(theta, act_bits, act_frac_bits),
                  quantize, scale, qmin, qmax)
    return delta, new_x_hat, nnz
