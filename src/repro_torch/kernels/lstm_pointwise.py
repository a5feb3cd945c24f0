"""Fused LSTM gate pointwise math (the Spartus HPE, Fig. 8) — CUDA port of
``repro/kernels/lstm_pointwise.py:lstm_pointwise_pallas``.

One launch over a pool's delta memories ``dm [B, 4, H]`` (gate order i,
g, f, o) and cell states ``c [B, H]`` -> ``(h, c')``
(``csrc/spartus_kernels.cu:lstm_pointwise_kernel``).  A CPU tensor runs
the plain version ``ref.lstm_pointwise_ref``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

KERNEL = _build.Kernel("lstm_pointwise")
plain = ref.lstm_pointwise_ref


def lstm_pointwise(dm: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dm [B, 4, H], c [B, H] float32 -> (h [B, H], c' [B, H])."""
    if dm.device.type == "cpu":
        return plain(dm, c)
    f32 = torch.float32
    device = _build.check_cuda("lstm_pointwise", {"dm": f32, "c": f32},
                               dm=dm, c=c)
    if dm.dim() != 3 or dm.shape[1] != 4 or c.shape != (dm.shape[0],
                                                         dm.shape[2]):
        raise ValueError(f"lstm_pointwise: expected dm [B, 4, H] and c "
                         f"[B, H], got {tuple(dm.shape)} and "
                         f"{tuple(c.shape)}")
    b, _, h = dm.shape
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    KERNEL.launch("spartus_lstm_pointwise", device, dm, c, h_out, c_out, b, h)
    return h_out, c_out
