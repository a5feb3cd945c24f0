"""Column-Balanced Targeted Dropout (CBTD) — Alg. 1 & 2 of the paper;
port of ``repro/core/cbtd.py``.

A weight matrix ``W [H, Q]`` is viewed as Q columns, each split into M
subcolumns by interleaving rows across the M PEs (row r -> PE ``r % M``,
local index ``r // M``).  In each subcolumn the ``floor(H/M * gamma)``
smallest elements by magnitude are dropped, each with probability
``alpha``.  At ``alpha = 1`` every subcolumn keeps exactly
``ceil(H/M * (1-gamma))`` nonzeros.  The magnitude ranking is a stable
double argsort, as in the reference, so ties drop the same elements.

Two granularities: element (``cbtd_mask``, Alg. 1) and tile
(``cbtd_tile_mask``: a balanced number of (tr x tc) tiles kept per
tile-column).  ``alpha_at`` is Alg. 2's annealing, and
``cbtd_prune_tree`` the trainer's post-update hook.

The alpha < 1 drops draw from a ``torch.Generator`` where the reference
draws from ``jax.random``: the same law, not the same draws.  Without a
generator the mask is deterministic and drops only when ``alpha >= 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import _tree

Alpha = Union[float, torch.Tensor]      # a host float or a 0-d CPU tensor


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


def _ranks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank (0 = smallest) of every element along ``dim``; ties keep
    index order."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)   # inverse permutation


def _drop(candidates: torch.Tensor, alpha: Alpha,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Which candidates drop: all of them at alpha >= 1 without a
    generator (none below), else each with probability alpha."""
    if generator is None:
        return candidates if float(alpha) >= 1.0 else torch.zeros_like(
            candidates)
    u = torch.rand(candidates.shape, generator=generator,
                   device=generator.device).to(candidates.device)
    return candidates & (u < float(alpha))


def cbtd_mask(w: torch.Tensor, gamma: float, m: int, alpha: Alpha = 1.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Alg. 1: boolean keep-mask for ``w``.  alpha < 1 needs
    ``generator`` to drop anything (stochastic targeted dropout)."""
    h, _ = w.shape
    s = _subcolumn_view(w, m)                       # [M, S, Q]
    candidates = _ranks(s.abs(), 1) < drop_count(h, m, gamma)
    return _subcolumn_unview(~_drop(candidates, alpha, generator))


def apply_cbtd(w: torch.Tensor, gamma: float, m: int, alpha: Alpha = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Alg. 1 applied: the pruned matrix ``w * mask``."""
    return w * cbtd_mask(w, gamma, m, alpha, generator).to(w.dtype)


# Tile-granular variant ------------------------------------------------------


def cbtd_tile_mask(w: torch.Tensor, gamma: float,
                   tile: Tuple[int, int] = (8, 128), alpha: Alpha = 1.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Tile-balanced CBTD: keep a fixed number of (tr x tc) tiles per
    tile-column, ranked by tile Frobenius norm; at alpha = 1 every
    tile-column keeps exactly ``n_tile_rows - floor(n_tile_rows *
    gamma)`` tiles."""
    tr, tc = tile
    h, q = w.shape
    if h % tr or q % tc:
        raise ValueError(f"shape {tuple(w.shape)} not divisible by tile "
                         f"{tile}")
    n_r, n_c = h // tr, q // tc
    tiles = w.reshape(n_r, tr, n_c, tc).to(torch.float32)
    norms = torch.sqrt((tiles ** 2).sum(dim=(1, 3)))          # [n_r, n_c]
    candidates = _ranks(norms, 0) < int(n_r * gamma)
    keep = ~_drop(candidates, alpha, generator)
    return keep.repeat_interleave(tr, 0).repeat_interleave(tc, 1)


# Training schedule (Alg. 2) -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CBTDConfig:
    """Per-layer CBTD configuration."""

    gamma: float = 0.94          # target sparsity
    m: int = 64                  # PEs per column (subcolumn granularity)
    delta_alpha: float = 1.0 / 30.0  # alpha ramp per epoch (paper: 1/30)
    granularity: str = "element"     # "element" | "tile"
    tile: Tuple[int, int] = (8, 128)

    def mask_fn(self, w, alpha: Alpha = 1.0,
                generator: Optional[torch.Generator] = None):
        if self.granularity == "element":
            return cbtd_mask(w, self.gamma, self.m, alpha, generator)
        return cbtd_tile_mask(w, self.gamma, self.tile, alpha, generator)


def alpha_at(epoch: int, delta_alpha: float) -> float:
    """Alg. 2: alpha ramps from 0 by delta_alpha per epoch, clipped at 1
    (computed in float32, as the reference does)."""
    return float(np.minimum(np.float32(epoch) * np.float32(delta_alpha),
                            np.float32(1.0)))


def effective_m(h: int, m: int) -> int:
    """Largest power-of-two divisor of ``h`` that is <= m (CBTD needs
    M | H)."""
    while m > 1 and h % m:
        m //= 2
    return max(m, 1)


def cbtd_prune_tree(params, layout: Dict[str, CBTDConfig], alpha: Alpha,
                    generator: Optional[torch.Generator] = None):
    """Apply CBTD to every leaf whose ``"/"``-joined path (``lstm/0/w_x``,
    ``fcl/w``) contains a layout pattern (``"*"`` matches all).  2-D
    leaves are pruned directly; >= 3-D leaves per trailing matrix;
    non-matching and 1-D leaves pass through.  The trainer's
    post-update hook (Alg. 2)."""

    def prune(name, leaf):
        cfg = _match_layout(name, layout)
        if cfg is None or leaf.ndim < 2:
            return leaf
        h = leaf.shape[-2]
        m_eff = (effective_m(h, cfg.m) if cfg.granularity == "element"
                 else cfg.m)

        def prune2d(w):
            if cfg.granularity == "element":
                mask = cbtd_mask(w, cfg.gamma, m_eff, alpha, generator)
            else:
                mask = cbtd_tile_mask(w, cfg.gamma, cfg.tile, alpha,
                                      generator)
            return w * mask.to(w.dtype)

        if leaf.ndim == 2:
            return prune2d(leaf)
        flat = leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
        return torch.stack([prune2d(w) for w in flat]).reshape(leaf.shape)

    return _tree.map_with_path(prune, params)


def _match_layout(name: str, layout: Dict[str, CBTDConfig]
                  ) -> Optional[CBTDConfig]:
    for pat, cfg in layout.items():
        if pat == "*" or pat in name:
            return cfg
    return None
