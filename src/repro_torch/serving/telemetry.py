"""Device-resident sparsity telemetry + latency summaries — port of
``repro/serving/telemetry.py``.

Telemetry is three ``[L, B]`` float32 accumulators (layer x slot) that
live on the pool's device and are updated in place by every pool step, so
the steady state never syncs with the host; ``measured_sparsity`` fetches
them on demand and reduces them to the batch-1 engine's summary:

  temporal_sparsity      = 1 - mean over (active step, layer) of nnz/n_cols
  capacity_overflow_rate = fraction of samples where the NZI list dropped
  mean_active_columns    = mean nnz per sample
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import hotpath_contract


class TelemetryState(NamedTuple):
    """Per-(layer, slot) accumulators over (active slot, frame) samples
    (float32: exact to 2^24 samples, then the ratios stay ~1e-7 true)."""

    nnz_sum: torch.Tensor         # [L, B] total fired deltas
    overflow_steps: torch.Tensor  # [L, B] samples where capacity dropped
    steps: torch.Tensor           # [L, B] number of samples


def init_telemetry(n_layers: int, n_slots: int,
                   device: torch.device) -> TelemetryState:
    def z() -> torch.Tensor:
        return torch.zeros((n_layers, n_slots), dtype=torch.float32,
                           device=device)

    return TelemetryState(nnz_sum=z(), overflow_steps=z(), steps=z())


def accumulate_layers(tel: TelemetryState, nnz: torch.Tensor,
                      dropped: torch.Tensor, active: torch.Tensor) -> None:
    """Fold one whole step in place: nnz/dropped [L, B] int32, active [B]
    bool."""
    act = active.to(torch.float32)
    tel.nnz_sum.add_(nnz.to(torch.float32) * act)
    tel.overflow_steps.add_((dropped > 0).to(torch.float32) * act)
    tel.steps.add_(act)


def percentile_summary(values: Sequence[float], name: str,
                       qs: Sequence[int] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p<q>_<name>": value}`` (0.0 for an empty sample)."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return {f"p{q}_{name}": 0.0 for q in qs}
    return {f"p{q}_{name}": float(np.percentile(arr, q)) for q in qs}


@hotpath_contract("fold_totals",
                  forbid_ops=("dot", "gather", "scatter",
                              "dynamic-update-slice"))
def fold_totals(tel: TelemetryState, n_cols: torch.Tensor) -> torch.Tensor:
    """The three running totals on device, no host sync:
    ``[sum_l nnz_sum_l / n_cols_l, overflow.sum(), steps.sum()]``.
    ``n_cols`` is the ``[L]`` float32 column count, already on the
    accumulators' device (a host list would be copied up with a sync)."""
    return torch.stack([(tel.nnz_sum / n_cols[:, None]).sum(),
                        tel.overflow_steps.sum(), tel.steps.sum()])


def summarize(nnz: np.ndarray, ovf: np.ndarray, steps: np.ndarray,
              n_cols: Sequence[int]) -> Dict[str, float]:
    """Reduce host copies of the accumulators to the engine's summary
    dict.  An idle pool returns the keys zeroed."""
    nnz, ovf, steps = (np.asarray(a, np.float64) for a in (nnz, ovf, steps))
    total = steps.sum()
    if total == 0:
        return {"temporal_sparsity": 0.0, "capacity_overflow_rate": 0.0,
                "mean_active_columns": 0.0}
    cols = np.asarray(n_cols, np.float64)[:, None]
    return {
        "temporal_sparsity": float(1.0 - (nnz / cols).sum() / total),
        "capacity_overflow_rate": float(ovf.sum() / total),
        "mean_active_columns": float(nnz.sum() / total),
    }


def measured_sparsity(tel: TelemetryState,
                      n_cols: Sequence[int]) -> Dict[str, float]:
    """Fetch the accumulators (the one host fetch of the telemetry path)
    and reduce them with `summarize`."""
    return summarize(*(a.detach().cpu().numpy() for a in tel), n_cols)
