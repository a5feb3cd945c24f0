"""Public wrappers the engines call — port of ``repro/kernels/ops.py``.

The delta encoder, the pointwise HPE math, the CBCSC SpMV, the
dense-mirror product and the dense route's capacity clip go through the
kernel modules (a CUDA kernel for a CUDA tensor, the plain PyTorch
version for a CPU tensor).  The rest is plain PyTorch in both places, as
it was XLA (not Pallas) in the reference:

* ``select_active_columns[_batch]`` — the fixed-capacity NZI list builder;
* the frame gather and the logits bank/gather of the chunked pool.

``delta_spmv_dense_topk_batch`` is two launches: the capacity clip
(``kernels/capacity_clip.py``) and the dense-mirror product
(``kernels/dense_mirror.py``, batch-invariant: see ``_mirror_matmul``).

The functions the reference declares hot-path contracts on carry the
same declarations (``repro_torch.analysis.contracts``).

Nothing here syncs with the host, so a chunk of frames stays capturable
as a CUDA graph.  Unlike the reference's ``ops``, the pool entry points
take the slot dimension natively: one launch per pool step, not a vmap.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.contracts import hotpath_contract
from repro_torch.kernels import capacity_clip as _cc
from repro_torch.kernels import delta_encode as _de
from repro_torch.kernels import dense_mirror as _dm
from repro_torch.kernels import lstm_pointwise as _lp
from repro_torch.kernels import stsp_spmv as _sp


def delta_encode(x: torch.Tensor, x_hat: torch.Tensor, theta: float, *,
                 act_bits: Optional[int] = None, act_frac_bits: int = 8):
    """Eqs. (4)-(5) for one session: x, x_hat [F] -> (delta [F],
    new_x_hat [F], nnz 0-d int32)."""
    delta, new_xh, nnz = _de.delta_encode(x[None], x_hat[None], theta,
                                          act_bits, act_frac_bits)
    return delta[0], new_xh[0], nnz[0]


def delta_encode_batch(x: torch.Tensor, x_hat: torch.Tensor, theta: float,
                       *, act_bits: Optional[int] = None,
                       act_frac_bits: int = 8):
    """Pool eqs. (4)-(5): x, x_hat [B, F] -> (delta [B, F], new_x_hat
    [B, F], nnz [B] int32)."""
    return _de.delta_encode(x, x_hat, theta, act_bits, act_frac_bits)


def delta_encode_step(x: torch.Tensor, h: torch.Tensor, s_hat: torch.Tensor,
                      theta: float, *, active: Optional[torch.Tensor] = None,
                      act_bits: Optional[int] = None,
                      act_frac_bits: int = 8):
    """The IPU stage of one pool layer-step in one launch: eqs. (4)-(5) on
    s = [x | h] (x [B, D] layer input, h [B, H] previous hidden state)
    against s_hat [B, D+H], which is updated in place for the slots
    ``active [B]`` selects (all if None) -> (delta [B, D+H], nnz [B]
    int32) for every slot.  The reference's concatenate, encode and
    masked ``where`` in one call."""
    return _de.delta_encode_step(x, h, s_hat, theta, active, act_bits,
                                 act_frac_bits)


def lstm_pointwise(dm: torch.Tensor, c: torch.Tensor):
    """HPE gate math for one session: dm [4, H], c [H] -> (h, c')."""
    h, c_new = _lp.lstm_pointwise(dm[None], c[None])
    return h[0], c_new[0]


def lstm_pointwise_batch(dm: torch.Tensor, c: torch.Tensor):
    """Pool HPE gate math: dm [B, 4, H], c [B, H] -> (h, c') [B, H]."""
    return _lp.lstm_pointwise(dm, c)


def lstm_pointwise_step(dm: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                        h: torch.Tensor, *,
                        active: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The accumulate + HPE stage of one pool layer-step in one launch:
    dm' = dm + y (dm, y [B, 4H]) and the gate math on dm' and c [B, H];
    dm', c' and h are written in place into dm, c and h for the slots
    ``active [B]`` selects (all if None) -> h [B, H] for every slot (the
    next layer's input).  The reference's add, HPE and masked ``where``s
    in one call."""
    return _lp.lstm_pointwise_step(dm, y, c, h, active)


def select_active_columns(delta: torch.Tensor, capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """NZI/NZV lists for one session: delta [F] -> (idx [K] int32,
    vals [K], n_dropped 0-d)."""
    idx, vals, n_dropped = select_active_columns_batch(delta[None], capacity)
    return idx[0], vals[0], n_dropped[0]


def select_active_columns_batch(delta: torch.Tensor, capacity: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Fixed-capacity NZI/NZV lists: delta [B, F] -> (idx [B, K] int32,
    vals [B, K], n_dropped [B] int32) with K = min(capacity, F).

    Keeps the K largest |delta| in descending order, ties toward the
    lower index, padding with idx=0, val=0.  That is ``lax.top_k``'s
    order in the reference; ``torch.topk`` does not promise it, so this
    is a stable descending sort."""
    k = min(capacity, delta.shape[-1])
    fired = delta != 0
    masked = torch.where(fired, delta.abs(), torch.full_like(delta, -1.0))
    top_mag, top_idx = torch.sort(masked, dim=-1, descending=True,
                                  stable=True)
    top_mag, top_idx = top_mag[..., :k], top_idx[..., :k]
    valid = top_mag > 0
    idx = torch.where(valid, top_idx, torch.zeros_like(top_idx))
    vals = torch.where(valid, torch.gather(delta, -1, top_idx),
                       torch.zeros_like(top_mag))
    n_dropped = torch.clamp(fired.sum(-1, dtype=torch.int32) - capacity,
                            min=0)
    return idx.to(torch.int32), vals, n_dropped


def stsp_spmv(val: torch.Tensor, lidx: torch.Tensor, idx: torch.Tensor,
              ds_vals: torch.Tensor, *, s: int,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One session: y [S*M] = sum_k ds_vals[k] * W_cbcsc[:, idx[k]] (fp32).
    ``scale`` dequantizes an int8 payload on the output (exact for the
    pack's power-of-two scales)."""
    y = _sp.stsp_spmv(val, lidx, idx, ds_vals, s=s)
    return y if scale is None else y * scale


def spmv_use_dense_gather(s: int, gamma: float) -> bool:
    """Route heuristic fixed at pack time: once ``S*(1-gamma) >= 1`` the
    CBCSC scatter has no arithmetic advantage per PE left, so the layer
    goes to the dense mirror."""
    return s * (1.0 - gamma) >= 1.0


@hotpath_contract("stsp_spmv_batch")
def stsp_spmv_batch(val: torch.Tensor, lidx: torch.Tensor, idx: torch.Tensor,
                    ds_vals: torch.Tensor, *, s: int,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pool SpMxSpV with shared CBCSC weights: idx, ds_vals [B, K] ->
    y [B, S*M] through the scatter kernel; ``scale`` dequantizes int8
    payloads on the output."""
    y = _sp.stsp_spmv_scatter_batch(val, lidx, idx, ds_vals, s=s)
    return y if scale is None else y * scale


def _mirror_matmul(ds: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ds [B, Q] @ w [Q, H] (float32 or int8, as packed) -> float32
    [B, H], then ``* scale``: the dense-mirror kernel.

    The product sits inside the recurrence, where a last-bit difference
    can flip a later delta threshold.  cuBLAS picks another fp32
    reduction order for another row count (B=1 vs B=16 rows differ by
    ~4e-6 at the 2x1024 model's shapes, and the pool then drifts 0.5 from
    the batch-1 engine in logits), so an fp32 GEMM would make a session's
    output depend on the pool around it.  The kernel sums every row in
    float64 registers in an order fixed by Q alone and rounds once, so a
    row is the same for 1, 16 or 32 rows and on the host and the card;
    the mirror stays at its packed dtype and no float64 tensor exists."""
    return _dm.dense_mirror(ds, w, scale)


@hotpath_contract("delta_spmv_dense_topk", forbid_ops=("transpose",),
                  op_budget={"dot": 1, "sort": 0})
def delta_spmv_dense_topk_batch(wt: torch.Tensor, delta: torch.Tensor,
                                capacity: int,
                                scale: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity clip + dense-mirror SpMV: wt [Q, H] (pre-transposed
    mirror, fp32 or int8), delta [B, Q] -> (y [B, H], n_dropped [B]).

    The reference clips under a ``lax.cond`` on "any row overflowed";
    branching here would need a host sync, so the count and the clip are
    one kernel (``kernels/capacity_clip.py``) that takes that branch per
    row on the device: bit-identical, and no sort.  Its ``sort: 0`` is
    the one clause stricter than the reference's ``sort: 1``."""
    ds, n_dropped = _cc.capacity_clip(delta, capacity)
    return _mirror_matmul(ds, wt, scale), n_dropped


def delta_spmv_dense_gather_batch(w: torch.Tensor, idx: torch.Tensor,
                                  ds_vals: torch.Tensor) -> torch.Tensor:
    """Dense-mirror SpMV from NZI lists: w [H, Q], idx/ds_vals [B, K] ->
    y [B, H].  The lists are scattered back to a dense [B, Q] slab
    (duplicates accumulate, padding adds 0.0) and contracted in one
    GEMM."""
    b = idx.shape[0]
    ds_dense = torch.zeros((b, w.shape[1]), dtype=torch.float32,
                           device=w.device)
    ds_dense.scatter_add_(1, idx.long(), ds_vals.to(torch.float32))
    return _mirror_matmul(ds_dense, w.T.contiguous())


@hotpath_contract("gather_frames", op_budget={"gather": 1})
def gather_frames(frames: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """Each slot's current frame: frames [B, T_buf, D], cursor [B] ->
    x [B, D].  The cursor is clamped to the buffer; rows of slots past
    their utterance are masked inactive by the caller."""
    t_buf = frames.shape[1]
    rows = torch.arange(frames.shape[0], device=frames.device)
    return frames[rows, torch.clamp(cursor, max=t_buf - 1).long()]


def _window(buf: torch.Tensor, start: torch.Tensor, n: int):
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = start.long()[:, None] + torch.arange(n, device=buf.device)[None]
    return rows, cols


@hotpath_contract("bank_rows", forbid_ops=("scatter",),
                  op_budget={"dynamic-update-slice": 1})
def bank_rows(buf: torch.Tensor, rows: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
    """Bank one chunk's logits in place: buf [B, T_pad, C], rows [N, B, C]
    -> slot b's rows land at ``buf[b, start[b] : start[b]+N]``.  The
    caller guarantees ``start[b] + N <= T_pad``.

    One ``index_copy_`` of the rows, in their own [N, B] order, onto the
    flat (slot, frame) rows of ``buf``: the windows are disjoint, so it is
    a plain update (no scatter, no transposed copy of ``rows``)."""
    n, b, c = rows.shape
    t_pad = buf.shape[1]
    slot = torch.arange(b, device=buf.device) * t_pad + start.long()
    flat = (torch.arange(n, device=buf.device)[:, None] + slot[None]
            ).reshape(-1)
    buf.view(b * t_pad, c).index_copy_(0, flat, rows.reshape(n * b, c))
    return buf


@hotpath_contract("gather_rows",
                  forbid_ops=("scatter", "dynamic-update-slice"))
def gather_rows(buf: torch.Tensor, start: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Inverse of ``bank_rows``: rows [B, n, C] with row b =
    ``buf[b, start[b] : start[b]+n]``."""
    r, c = _window(buf, start, n)
    return buf[r, c]
