"""Column-Balanced Targeted Dropout (CBTD) — Alg. 1 at alpha = 1; port of
``repro/core/cbtd.py``.

A weight matrix ``W [H, Q]`` is viewed as Q columns, each split into M
subcolumns by interleaving rows across the M PEs (row r -> PE ``r % M``,
local index ``r // M``).  In each subcolumn the ``floor(H/M * gamma)``
smallest elements by magnitude are dropped, so every subcolumn keeps
exactly ``ceil(H/M * (1-gamma))`` nonzeros.  The magnitude ranking is a
stable double argsort, as in the reference, so ties drop the same
elements.  The stochastic alpha < 1 ramp and the tile-granular variant
belong to the training stack and are not ported yet.
"""
from __future__ import annotations

import torch


def _subcolumn_view(w: torch.Tensor, m: int) -> torch.Tensor:
    """[H, Q] -> [M, H/M, Q] with interleaved row assignment."""
    h, q = w.shape
    if h % m != 0:
        raise ValueError(f"column height {h} not divisible by M={m}")
    return w.reshape(h // m, m, q).permute(1, 0, 2)


def _subcolumn_unview(s: torch.Tensor) -> torch.Tensor:
    """Inverse of _subcolumn_view: [M, H/M, Q] -> [H, Q]."""
    m, k, q = s.shape
    return s.permute(1, 0, 2).reshape(m * k, q)


def drop_count(h: int, m: int, gamma: float) -> int:
    """Alg. 1: dropped elements per subcolumn = floor(H/M * gamma)."""
    return int((h // m) * gamma)


def keep_count(h: int, m: int, gamma: float) -> int:
    """Nonzeros per subcolumn after CBTD at alpha=1 (= CBCSC BLEN)."""
    return (h // m) - drop_count(h, m, gamma)


def _rank_by_magnitude(s: torch.Tensor) -> torch.Tensor:
    """Rank (0 = smallest |.|) of every element along dim 1 of [M, S, Q]."""
    order = torch.argsort(s.abs(), dim=1, stable=True)
    return torch.argsort(order, dim=1)               # inverse permutation


def cbtd_mask(w: torch.Tensor, gamma: float, m: int) -> torch.Tensor:
    """Alg. 1 at alpha = 1: boolean keep-mask for ``w``."""
    h, _ = w.shape
    ranks = _rank_by_magnitude(_subcolumn_view(w, m))
    return _subcolumn_unview(ranks >= drop_count(h, m, gamma))


def apply_cbtd(w: torch.Tensor, gamma: float, m: int) -> torch.Tensor:
    """Alg. 1 applied: the pruned matrix ``w * mask``."""
    return w * cbtd_mask(w, gamma, m).to(w.dtype)
