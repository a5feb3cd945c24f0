"""Fused LSTM gate pointwise math (the Spartus HPE, Fig. 8) — CUDA port of
``repro/kernels/lstm_pointwise.py:lstm_pointwise_pallas``.

One launch over a pool's delta memories (gate order i, g, f, o) and cell
states (``csrc/spartus_kernels.cu:lstm_pointwise_kernel``).
``lstm_pointwise_step`` is the accumulate + HPE stage of one layer-step:
it adds the MAC output to the delta memories and writes dm, c and h back
in place for the active slots.  ``lstm_pointwise``, the reference's call
shape, runs the same kernel with nothing to add and separate outputs.  A
CPU tensor runs the plain version (``ref``); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis import hlo
from repro_torch.kernels import _build, ref

KERNEL = _build.Kernel("lstm_pointwise")
plain = ref.lstm_pointwise_ref
plain_step = ref.lstm_pointwise_step_ref

_F32 = torch.float32
_DTYPES = {"dm": _F32, "y": _F32, "c": _F32, "h": _F32,
           "active": torch.bool}


@hlo.kernel_region("lstm_pointwise")
def lstm_pointwise(dm: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dm [B, 4, H], c [B, H] float32 -> (h [B, H], c' [B, H])."""
    if dm.device.type == "cpu":
        return plain(dm, c)
    device = _build.check_cuda("lstm_pointwise", _DTYPES, dm=dm, c=c)
    if dm.dim() != 3 or dm.shape[1] != 4 or c.shape != (dm.shape[0],
                                                         dm.shape[2]):
        raise ValueError(f"lstm_pointwise: expected dm [B, 4, H] and c "
                         f"[B, H], got {tuple(dm.shape)} and "
                         f"{tuple(c.shape)}")
    b, _, hidden = dm.shape
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    KERNEL.launch("spartus_lstm_pointwise_step", device, dm, None, c, None,
                  h_out, None, c_out, None, b, hidden)
    return h_out, c_out


@hlo.kernel_region("lstm_pointwise")
def lstm_pointwise_step(dm: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                        h: torch.Tensor, active: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The accumulate + HPE stage of one layer-step: dm' = dm + y (dm, y
    [B, 4H]) and the gate math on dm' and c [B, H].  dm', c' and h are
    written in place into dm, c and h [B, H] for the rows ``active [B]``
    (bool) selects, all rows if None.  Returns h [B, H] for every row."""
    if dm.device.type == "cpu":
        return plain_step(dm, y, c, h, active)
    device = _build.check_cuda("lstm_pointwise", _DTYPES, dm=dm, y=y, c=c,
                               h=h, active=active)
    b, hidden = c.shape if c.dim() == 2 else (-1, -1)
    if (b < 0 or dm.shape != (b, 4 * hidden) or y.shape != dm.shape
            or h.shape != c.shape
            or (active is not None and active.shape != (b,))):
        raise ValueError(
            f"lstm_pointwise: expected dm, y [B, 4H], c, h [B, H] and "
            f"active [B], got {tuple(dm.shape)}, {tuple(y.shape)}, "
            f"{tuple(c.shape)}, {tuple(h.shape)} and "
            f"{None if active is None else tuple(active.shape)}")
    h_out = torch.empty_like(c)
    KERNEL.launch("spartus_lstm_pointwise_step", device, dm, y, c, active,
                  h_out, dm, c, h, b, hidden)
    return h_out
