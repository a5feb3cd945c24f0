"""Plain PyTorch versions of every kernel (the correctness contract);
port of ``repro/kernels/ref.py``.

Each function is the mathematical spec.  The kernel wrappers run them for
tensors on the CPU, and ``chip_smoke.py`` and the GPU tests hold each
CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quantization import quantize_act


def snap_theta(theta: float, act_bits: Optional[int] = None,
               act_frac_bits: int = 8) -> float:
    """The threshold as the float32 value the comparison uses (snapped to
    the Qm.n grid with ``act_bits``), returned as an exact Python float."""
    t = torch.tensor(theta, dtype=torch.float32)
    if act_bits is not None:
        t = quantize_act(t, act_bits, act_frac_bits)
    return float(t)


def delta_encode_ref(
    x: torch.Tensor, x_hat: torch.Tensor, theta: float,
    act_bits: Optional[int] = None, act_frac_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eqs. (4)-(5) over the last axis: x, x_hat [..., F] ->
    (delta, new_x_hat, nnz [...] int32).

    With ``act_bits`` the comparison runs on the Qm.n grid: x and theta
    are snapped first and the reference state stores the snapped x."""
    if act_bits is not None:
        x = quantize_act(x, act_bits, act_frac_bits)
    theta = snap_theta(theta, act_bits, act_frac_bits)
    raw = x - x_hat
    fired = raw.abs() > theta
    delta = torch.where(fired, raw, torch.zeros_like(raw))
    new_x_hat = torch.where(fired, x, x_hat)
    return delta, new_x_hat, fired.sum(-1, dtype=torch.int32)


def _masked_copy_(dst: torch.Tensor, src: torch.Tensor,
                  active: Optional[torch.Tensor]) -> None:
    """dst[b] = src[b] for the rows ``active [B]`` selects (all if None)."""
    if active is None:
        dst.copy_(src)
    else:
        dst.copy_(torch.where(active[:, None], src, dst))


def delta_encode_step_ref(
    x: torch.Tensor, h: torch.Tensor, s_hat: torch.Tensor, theta: float,
    active: Optional[torch.Tensor] = None, act_bits: Optional[int] = None,
    act_frac_bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IPU stage of one layer-step: ``delta_encode_ref`` on the layer
    state s = [x | h] (x [B, D], h [B, H]) against s_hat [B, D+H], which
    is updated IN PLACE for the rows ``active [B]`` selects (all if None).
    Returns (delta [B, D+H], nnz [B] int32), both for every row."""
    s = torch.cat([x, h], dim=-1)
    delta, new_s_hat, nnz = delta_encode_ref(s, s_hat, theta, act_bits,
                                             act_frac_bits)
    _masked_copy_(s_hat, new_s_hat, active)
    return delta, nnz


def _via_f64(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(torch.float64)).to(x.dtype)


def lstm_pointwise_ref(dm: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HPE post-MxV math: dm [..., 4, H] (i,g,f,o), c [..., H] -> (h, c').

    sigmoid and tanh are evaluated in float64 and rounded to float32: that
    is the correctly rounded float32 value (barring a near-tie), the same
    on the host and the card.  float32 library versions differ between
    the two by an ulp, which the delta thresholds downstream amplify."""
    i = _via_f64(torch.sigmoid, dm[..., 0, :])
    g = _via_f64(torch.tanh, dm[..., 1, :])
    f = _via_f64(torch.sigmoid, dm[..., 2, :])
    o = _via_f64(torch.sigmoid, dm[..., 3, :])
    c_new = f * c + i * g
    return o * _via_f64(torch.tanh, c_new), c_new


def lstm_pointwise_step_ref(dm: torch.Tensor, y: torch.Tensor,
                            c: torch.Tensor, h: torch.Tensor,
                            active: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The accumulate + HPE stage of one layer-step: dm' = dm + y (dm, y
    [B, 4H]), then ``lstm_pointwise_ref`` on dm' and c [B, H].  dm', c'
    and h are written IN PLACE into dm, c and h for the rows ``active
    [B]`` selects (all if None).  Returns h [B, H] for every row."""
    b, hidden = c.shape
    dm_new = dm + y
    h_new, c_new = lstm_pointwise_ref(dm_new.view(b, 4, hidden), c)
    _masked_copy_(c, c_new, active)
    _masked_copy_(h, h_new, active)
    _masked_copy_(dm, dm_new, active)
    return h_new


def stsp_spmv_ref(val: torch.Tensor, lidx: torch.Tensor, idx: torch.Tensor,
                  ds_vals: torch.Tensor, s: int) -> torch.Tensor:
    """One-hot spec of the Spartus MAC arrays: y[S*M] = sum_k ds[k] *
    column(idx[k]), each (value, lidx) pair landing at row lidx*M + pe.
    val/lidx [Q, M, BLEN] (lidx may be int8), idx/ds_vals [K]."""
    q, m, blen = val.shape
    v = val[idx.long()].to(torch.float32)                    # [K, M, BLEN]
    li = lidx[idx.long()].to(torch.int32)                    # widen int8
    onehot = li[..., None] == torch.arange(s, dtype=torch.int32,
                                           device=li.device)
    contrib = torch.einsum(
        "kmb,kmbs->ksm", v * ds_vals.to(torch.float32)[:, None, None],
        onehot.to(torch.float32))                            # [K, S, M]
    return contrib.sum(0).reshape(s * m)


def stsp_spmv_scatter_ref(val: torch.Tensor, lidx: torch.Tensor,
                          idx: torch.Tensor, ds_vals: torch.Tensor,
                          s: int) -> torch.Tensor:
    """Scatter-add formulation of ``stsp_spmv_ref`` for one session."""
    return stsp_spmv_scatter_batch_ref(val, lidx, idx[None], ds_vals[None],
                                       s)[0]


def stsp_spmv_scatter_batch_ref(val: torch.Tensor, lidx: torch.Tensor,
                                idx: torch.Tensor, ds_vals: torch.Tensor,
                                s: int) -> torch.Tensor:
    """Pool SpMxSpV: idx/ds_vals [B, K] -> y [B, S*M] float32.  Each
    fetched (value, lidx) pair is added once at row lidx*M + pe; duplicate
    columns accumulate and ds=0 padding adds zeros."""
    q, m, blen = val.shape
    b = idx.shape[0]
    cols = idx.long()
    v = val[cols].to(torch.float32) * ds_vals.to(torch.float32)[..., None,
                                                                None]
    pe = torch.arange(m, dtype=torch.int32, device=val.device)[:, None]
    # int32 row math: an int8-packed lidx would overflow at lidx*m
    rows = lidx[cols].to(torch.int32) * m + pe               # [B, K, M, BLEN]
    y = torch.zeros((b, s * m), dtype=torch.float32, device=val.device)
    return y.scatter_add_(1, rows.reshape(b, -1).long(), v.reshape(b, -1))


def dense_mirror_ref(ds: torch.Tensor, wt: torch.Tensor,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense-mirror product: ds [B, Q] float32 @ wt [Q, N] (float32
    or int8) -> y [B, N] float32, accumulated in float64 and rounded once,
    then ``y * scale`` in float32 (an int8 mirror's dequantization).

    Every product is exact in float64 and the float64 sum carries ~29
    more bits than the float32 it rounds to, so the result does not
    depend on the order of the sum (barring a near-tie at the final
    rounding): a row's value is the same whatever rows share the
    product, on the host and on the card."""
    y = (ds.to(torch.float64) @ wt.to(torch.float64)).to(torch.float32)
    return y if scale is None else y * scale
