"""Sparsity statistics & op accounting — eqs. (9)-(10), Table II/IV
columns; port of ``repro/core/stats.py``.

  * temporal sparsity (fraction of zero deltas; Fig. 13a),
  * weight sparsity (fraction of zero weights; Table II),
  * balance ratio BR across N MAC arrays (eq. 10; Fig. 12),
  * arithmetic-op savings of the MxV (Table II last column),
  * model size in MB at a given weight precision (Table II).

Reductions run in float32 like the reference's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import _tree


def temporal_sparsity(delta_masks: torch.Tensor) -> torch.Tensor:
    """Fraction of *zero* deltas.  delta_masks: bool, True = nonzero."""
    return 1.0 - delta_masks.to(torch.float32).mean()


def weight_sparsity(w: torch.Tensor) -> torch.Tensor:
    return (w == 0).to(torch.float32).mean()


def tree_weight_sparsity(params) -> float:
    """Zero fraction over every 2-D leaf of ``params``."""
    mats = [l for l in _tree.leaves(params)
            if isinstance(l, torch.Tensor) and l.ndim == 2]
    zeros = sum(int((l == 0).sum()) for l in mats)
    total = sum(l.numel() for l in mats)
    return zeros / max(total, 1)


def balance_ratio(delta_masks: torch.Tensor, n_arrays: int) -> torch.Tensor:
    """Eq. (10).  delta_masks: [T, F] bool (True = nonzero delta element).

    The state vector is partitioned into N contiguous segments, one per
    MAC array; WL_t^n = nonzeros in segment n at step t.
    BR = sum_t mean_n WL / sum_t max_n WL."""
    t, f = delta_masks.shape
    pad = (-f) % n_arrays
    if pad:
        delta_masks = torch.nn.functional.pad(delta_masks, (0, pad))
    wl = delta_masks.reshape(t, n_arrays, -1).to(torch.float32).sum(-1)
    return wl.mean(1).sum() / torch.clamp(wl.amax(1).sum(), min=1.0)


def lstm_layer_macs(input_dim: int, hidden_dim: int) -> int:
    """Dense MxV MACs of one LSTM step (the 8 stacked matrices, eq. 8)."""
    return 4 * hidden_dim * (input_dim + hidden_dim)


def lstm_layer_ops(input_dim: int, hidden_dim: int) -> int:
    """Op count (1 MAC = 2 Op), the unit of the paper's TOp/s numbers."""
    return 2 * lstm_layer_macs(input_dim, hidden_dim)


def op_saving(weight_sparsity: float, temporal_sparsity: float) -> float:
    """Table II 'Arithmetic Operations Saving': dense ops / remaining ops,
    ``1 / ((1 - ws) * (1 - ts))``."""
    rem = (1.0 - weight_sparsity) * (1.0 - temporal_sparsity)
    return 1.0 / max(rem, 1e-12)


def model_size_mb(n_params: int, bits: int) -> float:
    return n_params * bits / 8 / 1e6


def sparse_model_size_mb(n_params: int, ws: float, val_bits: int,
                         idx_bits: int) -> float:
    """Compressed size with CBCSC (VAL + LIDX per nonzero)."""
    nnz = n_params * (1.0 - ws)
    return nnz * (val_bits + idx_bits) / 8 / 1e6


def effective_mac_trace(nnz_dx: torch.Tensor, nnz_dh: torch.Tensor,
                        input_dim: int, hidden_dim: int,
                        weight_sparsity: float) -> torch.Tensor:
    """Per-step MACs a spatio-temporally sparse MxV executes: (active
    columns) x (nonzeros per column).  nnz_*: [T] int."""
    rows = 4 * hidden_dim * (1.0 - weight_sparsity)
    return (nnz_dx + nnz_dh).to(torch.float32) * rows


def summarize_delta_aux(aux: Dict[str, torch.Tensor], input_dim: int,
                        hidden_dim: int) -> Dict[str, float]:
    """Roll an aux dict from delta_lstm_layer into the paper's
    statistics."""
    nnz_dx = aux["nnz_dx"].to(torch.float32)
    nnz_dh = aux["nnz_dh"].to(torch.float32)
    ts_x = 1.0 - float(nnz_dx.mean() / input_dim)
    ts_h = 1.0 - float(nnz_dh.mean() / hidden_dim)
    total = float((nnz_dx + nnz_dh).mean()) / (input_dim + hidden_dim)
    return {
        "temporal_sparsity_dx": ts_x,
        "temporal_sparsity_dh": ts_h,
        "temporal_sparsity": 1.0 - total,
    }
