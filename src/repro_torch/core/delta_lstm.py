"""DeltaLSTM — the paper's core algorithm (Sec. II-B, eqs. 3-7); port of
``repro/core/delta_lstm.py``.

Gate pre-activations are *delta memories* ``D`` accumulated from
thresholded temporal deltas of the input and hidden state:

    D_{g,t} = W_xg Δx_t + W_hg Δh_{t-1} + D_{g,t-1}

Gate order is (i, g, f, o) everywhere (eq. 8).  Weights are stored
stacked: W_x [4H, D], W_h [4H, H].  Unlike the reference, which vmaps a
single-row function, every function here takes any number of leading
batch dimensions (``x [..., D]``, ``h [..., H]``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, Any]


class DeltaLSTMState(NamedTuple):
    """Carried state of one DeltaLSTM layer (shapes [..., ·])."""

    h: torch.Tensor      # hidden state            [..., H]
    c: torch.Tensor      # cell state              [..., H]
    x_hat: torch.Tensor  # reference input  x̂      [..., D]
    h_hat: torch.Tensor  # reference hidden ĥ      [..., H]
    dm: torch.Tensor     # delta memories D        [..., 4, H]


def init_lstm_params(generator: torch.Generator, input_dim: int,
                     hidden_dim: int, dtype: torch.dtype = torch.float32,
                     device=None) -> Params:
    """Standard LSTM init (uniform fan-in, forget-bias 1).  Drawn from
    ``generator`` on its own device, then moved to ``device``, so a seed
    gives the same weights on every device."""
    bound = 1.0 / math.sqrt(hidden_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return ((u * 2.0 - 1.0) * bound).to(device)

    w_x = uniform((4 * hidden_dim, input_dim))
    w_h = uniform((4 * hidden_dim, hidden_dim))
    b = torch.zeros((4, hidden_dim), dtype=dtype, device=device)
    b[2] = 1.0                   # forget gate (i, g, f, o order)
    return {"w_x": w_x, "w_h": w_h, "b": b}


def init_delta_lstm_state(params: Params,
                          batch_shape: Tuple[int, ...] = ()
                          ) -> DeltaLSTMState:
    """Initial state: zeros, delta memories at t=1 equal the biases."""
    four_h, d = params["w_x"].shape
    h = four_h // 4
    kw = dict(dtype=params["w_x"].dtype, device=params["w_x"].device)
    return DeltaLSTMState(
        h=torch.zeros(batch_shape + (h,), **kw),
        c=torch.zeros(batch_shape + (h,), **kw),
        x_hat=torch.zeros(batch_shape + (d,), **kw),
        h_hat=torch.zeros(batch_shape + (h,), **kw),
        dm=params["b"].expand(batch_shape + (4, h)).clone(),
    )


def _gates(pre: torch.Tensor):
    """pre: [..., 4, H] stacked (i, g, f, o) pre-activations."""
    return (torch.sigmoid(pre[..., 0, :]), torch.tanh(pre[..., 1, :]),
            torch.sigmoid(pre[..., 2, :]), torch.sigmoid(pre[..., 3, :]))


def _stacked_matvec(params: Params, x: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """W_x x + W_h h as [..., 4, H]."""
    y = x @ params["w_x"].T + h @ params["w_h"].T
    return y.reshape(y.shape[:-1] + (4, -1))


def lstm_step(params: Params, h: torch.Tensor, c: torch.Tensor,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain LSTM step, eq. (1)."""
    i, g, f, o = _gates(_stacked_matvec(params, x, h) + params["b"])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def delta_threshold(cur: torch.Tensor, ref: torch.Tensor, theta: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (4)-(7): (delta, new_ref); delta = cur-ref where |.| > theta."""
    raw = cur - ref
    fired = raw.abs() > theta
    delta = torch.where(fired, raw, torch.zeros_like(raw))
    return delta, torch.where(fired, cur, ref)


def delta_lstm_step(params: Params, state: DeltaLSTMState, x: torch.Tensor,
                    theta: float
                    ) -> Tuple[DeltaLSTMState, torch.Tensor, Dict[str, Any]]:
    """One DeltaLSTM step, eqs. (3)-(7) -> (new_state, h, aux)."""
    dx, x_hat = delta_threshold(x, state.x_hat, theta)
    dh, h_hat = delta_threshold(state.h, state.h_hat, theta)
    dm = state.dm + _stacked_matvec(params, dx, dh)
    i, g, f, o = _gates(dm)
    c = f * state.c + i * g
    h = o * torch.tanh(c)
    aux = {
        "nnz_dx": (dx != 0).sum(-1, dtype=torch.int32),
        "nnz_dh": (dh != 0).sum(-1, dtype=torch.int32),
        "dx_mask": dx != 0,
        "dh_mask": dh != 0,
    }
    return DeltaLSTMState(h=h, c=c, x_hat=x_hat, h_hat=h_hat, dm=dm), h, aux


def lstm_layer(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """Plain LSTM over a sequence: xs [..., T, D] -> [..., T, H]."""
    hdim = params["w_h"].shape[-1]
    h = xs.new_zeros(xs.shape[:-2] + (hdim,))
    c = torch.zeros_like(h)
    hs = []
    for t in range(xs.shape[-2]):
        h, c = lstm_step(params, h, c, xs[..., t, :])
        hs.append(h)
    return torch.stack(hs, dim=-2)


def delta_lstm_layer(params: Params, xs: torch.Tensor, theta: float,
                     state: Optional[DeltaLSTMState] = None):
    """DeltaLSTM over a sequence: xs [..., T, D] -> (hs [..., T, H], final
    state, aux) with aux["nnz_dx"/"nnz_dh"] of shape [..., T]."""
    if state is None:
        state = init_delta_lstm_state(params, tuple(xs.shape[:-2]))
    hs, auxs = [], []
    for t in range(xs.shape[-2]):
        state, h, aux = delta_lstm_step(params, state, xs[..., t, :], theta)
        hs.append(h)
        auxs.append(aux)
    aux = {
        "nnz_dx": torch.stack([a["nnz_dx"] for a in auxs], dim=-1),
        "nnz_dh": torch.stack([a["nnz_dh"] for a in auxs], dim=-1),
        "dx_masks": torch.stack([a["dx_mask"] for a in auxs], dim=-2),
        "dh_masks": torch.stack([a["dh_mask"] for a in auxs], dim=-2),
    }
    return torch.stack(hs, dim=-2), state, aux


# The reference vmaps its single-row layers over a leading batch axis; the
# port's layers take [..., T, D] already, so the batched names are the same
# functions.
lstm_layer_batched = lstm_layer
delta_lstm_layer_batched = delta_lstm_layer


def stacked_weight_matrix(params: Params) -> torch.Tensor:
    """Eq. (8): the [4H, D+H] stacked matrix the accelerator stores."""
    return torch.cat([params["w_x"], params["w_h"]], dim=1)
