"""Off-chip DRAM access-energy model (Sec. VII-C, Table VII, Fig. 14); a
copy of ``repro/hwsim/memory.py``.

Energy per inference frame = bits fetched from DRAM x energy/bit.
Spatio-temporal sparsity reduces fetched weight bits by
(1-gamma)x(1-temporal_sparsity) plus the CBCSC index overhead — the
paper reports a 91.7x reduction for Edge-Spartus; we reproduce the
figure from our measured sparsities.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# Table VII: DRAM access energy per bit (pJ)
DRAM_ENERGY_PJ_PER_BIT = {
    "DDR3": 20.3,
    "DDR3L": 16.5,   # scaled from DDR3 by supply voltage (paper footnote)
    "GDDR6": 5.5,
    "HBM2": 3.9,
}


@dataclasses.dataclass(frozen=True)
class FetchModel:
    weight_bits: int = 8
    index_bits: int = 10      # Edge-Spartus LIDX
    act_bits: int = 16


def weight_bits_per_frame(
    n_weights: int, gamma: float, temporal_sparsity: float,
    fm: FetchModel = FetchModel(),
) -> float:
    """Bits of weight traffic for one inference frame (batch-1 MxV)."""
    active_cols = 1.0 - temporal_sparsity
    nnz = n_weights * (1.0 - gamma)
    per_nz_bits = fm.weight_bits + (fm.index_bits if gamma > 0 else 0)
    return nnz * active_cols * per_nz_bits


def dense_bits_per_frame(n_weights: int, fm: FetchModel = FetchModel()) -> float:
    return n_weights * fm.weight_bits


def energy_per_frame_uj(bits: float, dram: str) -> float:
    return bits * DRAM_ENERGY_PJ_PER_BIT[dram] * 1e-12 * 1e6


def fig14_table(
    n_weights: int, gamma: float, temporal_sparsity: float,
    fm: FetchModel = FetchModel(),
) -> Dict[str, Dict[str, float]]:
    """Fig. 14: energy/frame for dense vs CBTD vs spatio-temporal, per
    DRAM type; plus the paper's headline reduction factor."""
    rows = {}
    dense = dense_bits_per_frame(n_weights, fm)
    cbtd = weight_bits_per_frame(n_weights, gamma, 0.0, fm)
    st = weight_bits_per_frame(n_weights, gamma, temporal_sparsity, fm)
    for dram in DRAM_ENERGY_PJ_PER_BIT:
        rows[dram] = {
            "dense_uj": energy_per_frame_uj(dense, dram),
            "cbtd_uj": energy_per_frame_uj(cbtd, dram),
            "spatio_temporal_uj": energy_per_frame_uj(st, dram),
        }
    # the paper's 91.7x headline ignores the CBCSC index bits (pure op/
    # traffic-saving factor 1/((1-gamma)(1-ts))); we report both that and
    # the honest figure including LIDX overhead:
    st_no_idx = weight_bits_per_frame(
        n_weights, gamma, temporal_sparsity,
        FetchModel(fm.weight_bits, 0, fm.act_bits))
    rows["reduction"] = {
        "dense_over_st_with_index": dense / max(st, 1e-9),
        "dense_over_st": dense / max(st_no_idx, 1e-9),
    }
    return rows
