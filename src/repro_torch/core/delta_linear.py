"""DeltaLinear — eq. (2) generalised to any linear layer applied over
time; port of ``repro/core/delta_linear.py``.

    y_t = W Δx_t + y_{t-1},   Δx_t thresholded per eqs. (4)-(5)

This is the framework's generalisation of the paper's insight beyond the
LSTM: *any* time-distributed linear layer over a temporally smooth signal
(speech frames, SSM conv features, recurrent-block inputs) can skip weight
columns for sub-threshold deltas.  For token-embedding inputs (text LMs)
the mechanism is supported but yields near-zero sparsity.

State per layer: (x̂ reference input, y running output).  Plain PyTorch,
as in the reference.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.delta_lstm import delta_threshold


class DeltaLinearState(NamedTuple):
    x_hat: torch.Tensor  # [..., D]
    y: torch.Tensor      # [..., O]


def init_delta_linear_state(
    batch_shape: Tuple[int, ...], input_dim: int, out_dim: int,
    bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
    device=None,
) -> DeltaLinearState:
    """Zeros (y starts at the bias if given), on ``bias``' device if
    given."""
    if bias is not None:
        device = bias.device
    y0 = torch.zeros(batch_shape + (out_dim,), dtype=dtype, device=device)
    if bias is not None:
        y0 = y0 + bias.to(dtype)
    return DeltaLinearState(
        x_hat=torch.zeros(batch_shape + (input_dim,), dtype=dtype,
                          device=device), y=y0)


def delta_linear_step(
    w: torch.Tensor, state: DeltaLinearState, x: torch.Tensor, theta: float,
) -> Tuple[DeltaLinearState, torch.Tensor, Dict[str, torch.Tensor]]:
    """One step.  w: [O, D]; x: [..., D] -> y: [..., O]."""
    dx, x_hat = delta_threshold(x, state.x_hat, theta)
    y = state.y + dx @ w.T
    aux = {"nnz_dx": (dx != 0).sum(-1, dtype=torch.int32)}
    return DeltaLinearState(x_hat=x_hat, y=y), y, aux


def delta_linear_over_time(
    w: torch.Tensor, xs: torch.Tensor, theta: float,
    bias: Optional[torch.Tensor] = None,
    state: Optional[DeltaLinearState] = None,
) -> Tuple[torch.Tensor, DeltaLinearState, Dict[str, torch.Tensor]]:
    """Over the leading (time) axis, as the reference's scan:
    xs [T, ..., D] -> (ys [T, ..., O], final state, aux) with
    aux["nnz_dx"] of shape [T, ...]."""
    out_dim, input_dim = w.shape
    if state is None:
        state = init_delta_linear_state(tuple(xs.shape[1:-1]), input_dim,
                                        out_dim, bias, xs.dtype, w.device)
    ys, nnz = [], []
    for x in xs:
        state, y, aux = delta_linear_step(w, state, x, theta)
        ys.append(y)
        nnz.append(aux["nnz_dx"])
    return torch.stack(ys), state, {"nnz_dx": torch.stack(nnz)}
