"""DeltaGRU — the prior Delta Network RNN (Neil et al. 2017; DeltaRNN
FPGA'18); port of ``repro/core/delta_gru.py``.

Implemented as the baseline the paper extends (Sec. II: "The DN algorithm
was only studied and implemented as DeltaGRU. The DeltaLSTM extends the DN
algorithm to LSTM RNNs").  Used in benchmarks to compare DeltaLSTM against
the prior art's algorithmic behaviour.

GRU formulation (cuDNN variant, as used by DeltaGRU so that the reset gate
applies to the *recurrent matmul output*, which makes the delta memory
decomposition exact):

    r_t = σ(W_xr x_t + W_hr h_{t-1} + b_r)
    u_t = σ(W_xu x_t + W_hu h_{t-1} + b_u)
    c_t = tanh(W_xc x_t + r_t ⊙ (W_hc h_{t-1} + b_hc) + b_xc)
    h_t = (1-u_t) ⊙ c_t + u_t ⊙ h_{t-1}

Delta memories: M_r, M_u accumulate both matmul streams; the candidate gate
needs the recurrent stream kept separate (M_hc) because of the r_t gating.
Weights are stacked (r, u, c) along the first axis: W_x [3H, D], W_h
[3H, H].  Plain PyTorch (the reference has no kernel here either).  As in
``core/delta_lstm.py``, every function takes any number of leading batch
dimensions (``x [..., D]``, sequences ``xs [..., T, D]``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.delta_lstm import delta_threshold

Params = Dict[str, Any]


class DeltaGRUState(NamedTuple):
    h: torch.Tensor       # [..., H]
    x_hat: torch.Tensor   # [..., D]
    h_hat: torch.Tensor   # [..., H]
    m_r: torch.Tensor     # [..., H]
    m_u: torch.Tensor     # [..., H]
    m_xc: torch.Tensor    # [..., H]
    m_hc: torch.Tensor    # [..., H]


def init_gru_params(generator: torch.Generator, input_dim: int,
                    hidden_dim: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Params:
    """Uniform fan-in init, zero biases; drawn from ``generator`` on its
    own device, then moved to ``device``."""
    bound = 1.0 / math.sqrt(hidden_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return ((u * 2.0 - 1.0) * bound).to(device)

    w_x = uniform((3 * hidden_dim, input_dim))
    w_h = uniform((3 * hidden_dim, hidden_dim))
    zeros = torch.zeros((3, hidden_dim), dtype=dtype, device=device)
    return {"w_x": w_x, "w_h": w_h, "b_x": zeros, "b_h": zeros.clone()}


def _split3(y: torch.Tensor) -> torch.Tensor:
    """[..., 3H] -> [..., 3, H] (gates r, u, c)."""
    return y.reshape(y.shape[:-1] + (3, -1))


def gru_step(params: Params, h: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    px = _split3(x @ params["w_x"].T) + params["b_x"]
    ph = _split3(h @ params["w_h"].T) + params["b_h"]
    r = torch.sigmoid(px[..., 0, :] + ph[..., 0, :])
    u = torch.sigmoid(px[..., 1, :] + ph[..., 1, :])
    c = torch.tanh(px[..., 2, :] + r * ph[..., 2, :])
    return (1.0 - u) * c + u * h


def init_delta_gru_state(input_dim: int, hidden_dim: int,
                         params: Optional[Params] = None,
                         dtype: torch.dtype = torch.float32, *,
                         batch_shape: Tuple[int, ...] = (),
                         device=None) -> DeltaGRUState:
    """Zeros, and with ``params`` the delta memories at t=1 equal to the
    biases.  One tensor per field (none shares storage with another or
    with ``params``); on ``params``' device if given."""
    if params is not None:
        device = params["b_x"].device
    shape = batch_shape + (hidden_dim,)

    def z() -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    if params is not None:
        b_x, b_h = params["b_x"].to(dtype), params["b_h"].to(dtype)
        mems = (b_x[0] + b_h[0], b_x[1] + b_h[1], b_x[2], b_h[2])
        m_r, m_u, m_xc, m_hc = (m.expand(shape).clone() for m in mems)
    else:
        m_r, m_u, m_xc, m_hc = z(), z(), z(), z()
    return DeltaGRUState(
        h=z(), x_hat=torch.zeros(batch_shape + (input_dim,), dtype=dtype,
                                 device=device),
        h_hat=z(), m_r=m_r, m_u=m_u, m_xc=m_xc, m_hc=m_hc)


def delta_gru_step(params: Params, state: DeltaGRUState, x: torch.Tensor,
                   theta: float
                   ) -> Tuple[DeltaGRUState, torch.Tensor,
                              Dict[str, torch.Tensor]]:
    """One DeltaGRU step -> (new_state, h, aux) with aux["nnz_dx"/"nnz_dh"]
    the fired counts (int32, one per batch row)."""
    dx, x_hat = delta_threshold(x, state.x_hat, theta)
    dh, h_hat = delta_threshold(state.h, state.h_hat, theta)

    px = _split3(dx @ params["w_x"].T)
    ph = _split3(dh @ params["w_h"].T)
    m_r = state.m_r + px[..., 0, :] + ph[..., 0, :]
    m_u = state.m_u + px[..., 1, :] + ph[..., 1, :]
    m_xc = state.m_xc + px[..., 2, :]
    m_hc = state.m_hc + ph[..., 2, :]

    r = torch.sigmoid(m_r)
    u = torch.sigmoid(m_u)
    c = torch.tanh(m_xc + r * m_hc)
    h = (1.0 - u) * c + u * state.h

    aux = {"nnz_dx": (dx != 0).sum(-1, dtype=torch.int32),
           "nnz_dh": (dh != 0).sum(-1, dtype=torch.int32)}
    new = DeltaGRUState(h=h, x_hat=x_hat, h_hat=h_hat,
                        m_r=m_r, m_u=m_u, m_xc=m_xc, m_hc=m_hc)
    return new, h, aux


def gru_layer(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """Plain GRU over a sequence: xs [..., T, D] -> [..., T, H]."""
    hdim = params["w_h"].shape[-1]
    h = xs.new_zeros(xs.shape[:-2] + (hdim,))
    hs = []
    for t in range(xs.shape[-2]):
        h = gru_step(params, h, xs[..., t, :])
        hs.append(h)
    return torch.stack(hs, dim=-2)


def delta_gru_layer(params: Params, xs: torch.Tensor, theta: float,
                    state: Optional[DeltaGRUState] = None
                    ) -> Tuple[torch.Tensor, DeltaGRUState,
                               Dict[str, torch.Tensor]]:
    """DeltaGRU over a sequence: xs [..., T, D] -> (hs [..., T, H], final
    state, aux) with aux["nnz_dx"/"nnz_dh"] of shape [..., T]."""
    input_dim = params["w_x"].shape[-1]
    hdim = params["w_h"].shape[-1]
    if state is None:
        state = init_delta_gru_state(input_dim, hdim, params, xs.dtype,
                                     batch_shape=tuple(xs.shape[:-2]))
    hs, nnz_dx, nnz_dh = [], [], []
    for t in range(xs.shape[-2]):
        state, h, aux = delta_gru_step(params, state, xs[..., t, :], theta)
        hs.append(h)
        nnz_dx.append(aux["nnz_dx"])
        nnz_dh.append(aux["nnz_dh"])
    return torch.stack(hs, dim=-2), state, {
        "nnz_dx": torch.stack(nnz_dx, dim=-1),
        "nnz_dh": torch.stack(nnz_dh, dim=-1)}
