"""Cycle-approximate Spartus performance model (Sec. IV/VI-C, Tables IV/V/VI);
a copy of ``repro/hwsim/spartus_model.py`` (``tests/test_torch_hwsim.py``
holds the two equal).

The FPGA cannot run here, so hardware latency/throughput are *modelled*
and driven by the real sparsity statistics measured from the nets
(DESIGN.md §2 "what does not transfer").  The model:

    cycles/step = max_n(WL_t^n) * BLEN + OVH
      WL_t^n : nonzero delta count routed to MAC array n at step t
               (measured masks -> exact; or analytic (1-ts)/N/BR)
      BLEN   : nonzeros per subcolumn = ceil(4H/M * (1-gamma))  [spatial]
      OVH    : pipeline fill + IPU encode + HPE activation overhead
               (calibrated once against Table IV, default 126 cycles)

Validation against the paper (tests/test_hwsim.py):
  * eq. (9) peak:           204.8 GOp/s (Spartus), 1.0 GOp/s (Edge)
  * dense baseline latency: ~46 us for the 123->1024 DeltaLSTM layer
  * Table IV ladder:        +CBTD ~3.3 us, +Delta(0.1) ~1.6 us,
                            +Delta(0.3) ~1.0 us  -> ~9.4 TOp/s effective
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpartusHW:
    name: str = "Spartus"
    n_arrays: int = 8          # N MAC arrays
    pes_per_array: int = 64    # M PEs per array
    f_clk_hz: float = 200e6
    overhead_cycles: float = 126.0  # calibrated vs Table IV
    # Edge-Spartus fetches weights from DDR3L: bandwidth-bound extra term
    offchip_bytes_per_cycle: float = 0.0  # 0 = on-chip BRAM (big Spartus)

    @property
    def n_macs(self) -> int:
        return self.n_arrays * self.pes_per_array

    def peak_ops(self) -> float:
        """Eq. (9): nu_peak = 2 * f * K."""
        return 2.0 * self.f_clk_hz * self.n_macs


SPARTUS = SpartusHW()
EDGE_SPARTUS = SpartusHW(
    name="Edge-Spartus", n_arrays=1, pes_per_array=4, f_clk_hz=125e6,
    overhead_cycles=126.0,
    # 72-bit @ DDR3L-ish effective rate relative to PL clock (Sec. VII-B)
    offchip_bytes_per_cycle=9.0,
)


@dataclasses.dataclass(frozen=True)
class LayerDims:
    input_dim: int
    hidden_dim: int

    @property
    def n_cols(self) -> int:          # columns of the stacked matrix (eq. 8)
        return self.input_dim + self.hidden_dim

    @property
    def col_height(self) -> int:
        return 4 * self.hidden_dim

    @property
    def dense_macs(self) -> int:
        return self.col_height * self.n_cols

    @property
    def dense_ops(self) -> int:
        return 2 * self.dense_macs


# paper's hardware test network: top of the 2L-1024H AM fed by 123-dim
# features (#Parameters = 4.7 M in Table V = 4*1024*(1024+123))
TEST_LAYER = LayerDims(input_dim=123, hidden_dim=1024)


def blen(hw: SpartusHW, dims: LayerDims, gamma: float) -> int:
    s = dims.col_height // hw.pes_per_array
    return int(np.ceil(s * (1.0 - gamma)))


def step_cycles_from_masks(
    hw: SpartusHW, dims: LayerDims, gamma: float, delta_masks: np.ndarray,
) -> np.ndarray:
    """Exact trace-driven cycles per step.  delta_masks: [T, F] bool of the
    concatenated delta state vector (True = nonzero -> column fetched)."""
    t, f = delta_masks.shape
    pad = (-f) % hw.n_arrays
    if pad:
        delta_masks = np.pad(delta_masks, ((0, 0), (0, pad)))
    wl = delta_masks.reshape(t, hw.n_arrays, -1).sum(-1)        # [T, N]
    max_wl = wl.max(axis=1)
    b = blen(hw, dims, gamma)
    cycles = max_wl * b + hw.overhead_cycles
    if hw.offchip_bytes_per_cycle > 0:
        # weight fetch: VAL(1B)+LIDX(~1.25B) per nonzero, per active column
        bytes_step = wl.sum(axis=1) * b * hw.pes_per_array * 2.25
        cycles = np.maximum(cycles, bytes_step / hw.offchip_bytes_per_cycle)
    return cycles


def step_cycles_analytic(
    hw: SpartusHW, dims: LayerDims, gamma: float, temporal_sparsity: float,
    balance_ratio: float = 1.0,
) -> float:
    """Expected cycles per step from summary statistics (used where no
    trace is available): max workload ~ mean/(BR)."""
    active = (1.0 - temporal_sparsity) * dims.n_cols
    max_wl = active / hw.n_arrays / max(balance_ratio, 1e-6)
    b = blen(hw, dims, gamma)
    cycles = max_wl * b + hw.overhead_cycles
    if hw.offchip_bytes_per_cycle > 0:
        bytes_step = active * b * hw.pes_per_array * 2.25
        cycles = max(cycles, bytes_step / hw.offchip_bytes_per_cycle)
    return float(cycles)


@dataclasses.dataclass
class HWReport:
    name: str
    latency_us: float
    batch1_throughput_gops: float   # effective: dense ops / latency
    peak_gops: float
    speedup_vs_peak: float          # effective / peak ("Speedup" in Table V)
    kfps: float

    def to_dict(self):
        return dataclasses.asdict(self)


def evaluate(
    hw: SpartusHW, dims: LayerDims, gamma: float,
    temporal_sparsity: float = 0.0, balance_ratio: float = 1.0,
    delta_masks: Optional[np.ndarray] = None,
) -> HWReport:
    """Model one DeltaLSTM layer (the paper's batch-1 benchmark)."""
    if delta_masks is not None:
        cycles = float(np.mean(step_cycles_from_masks(hw, dims, gamma,
                                                      delta_masks)))
    else:
        cycles = step_cycles_analytic(hw, dims, gamma, temporal_sparsity,
                                      balance_ratio)
    lat_s = cycles / hw.f_clk_hz
    eff = dims.dense_ops / lat_s
    peak = hw.peak_ops()
    return HWReport(
        name=hw.name,
        latency_us=lat_s * 1e6,
        batch1_throughput_gops=eff / 1e9,
        peak_gops=peak / 1e9,
        speedup_vs_peak=eff / peak,
        kfps=1.0 / lat_s / 1e3,
    )


def evaluate_from_telemetry(
    hw: SpartusHW, dims: LayerDims, gamma: float,
    sparsity: Dict[str, float], balance_ratio: float = 0.75,
) -> HWReport:
    """Model a layer from an *aggregated* telemetry summary — the dict
    produced by the serving engines' ``measured_sparsity()`` (device-side
    accumulators, one host fetch), replacing the old per-step-dict flow.
    Uses ``temporal_sparsity`` and, when present, ``balance_ratio``."""
    return evaluate(
        hw, dims, gamma,
        temporal_sparsity=sparsity.get("temporal_sparsity", 0.0),
        balance_ratio=sparsity.get("balance_ratio", balance_ratio),
    )


def dense_baseline(hw: SpartusHW, dims: LayerDims) -> HWReport:
    """'No Opt.' row of Table IV: dense MxV on the MAC arrays."""
    cycles = dims.dense_macs / hw.n_macs + hw.overhead_cycles
    if hw.offchip_bytes_per_cycle > 0:
        cycles = max(cycles, dims.dense_macs * 1.0 / hw.offchip_bytes_per_cycle)
    lat_s = cycles / hw.f_clk_hz
    return HWReport(
        name=hw.name + " (dense)",
        latency_us=lat_s * 1e6,
        batch1_throughput_gops=dims.dense_ops / lat_s / 1e9,
        peak_gops=hw.peak_ops() / 1e9,
        speedup_vs_peak=(dims.dense_ops / lat_s) / hw.peak_ops(),
        kfps=1.0 / lat_s / 1e3,
    )


def table4_ladder(
    hw: SpartusHW = SPARTUS,
    dims: LayerDims = TEST_LAYER,
    gamma: float = 0.9375,
    ts_by_theta: Optional[Dict[float, float]] = None,
    br_by_theta: Optional[Dict[float, float]] = None,
) -> Dict[str, HWReport]:
    """Reproduce Table IV: No Opt -> +CBTD -> +DeltaLSTM(0.1/0.3).
    Default sparsities are the paper's measured values; callers pass our
    own measured values for the trace-driven reproduction."""
    ts = ts_by_theta or {0.1: 0.7422, 0.3: 0.9060}
    br = br_by_theta or {0.1: 0.80, 0.3: 0.73}
    out = {"no_opt": dense_baseline(hw, dims)}
    out["cbtd"] = evaluate(hw, dims, gamma, temporal_sparsity=0.0,
                           balance_ratio=1.0)
    for theta, t in sorted(ts.items()):
        out[f"delta_{theta}"] = evaluate(hw, dims, gamma, t,
                                         br.get(theta, 0.75))
    return out


# -- Table V / VI constants (prior accelerators, from the paper) --------------

PRIOR_ACCELERATORS = {
    "ESE":       dict(eff_gops=78.6,   power_w=41.0, latency_us=82.7, platform="XCKU060"),
    "DeltaRNN":  dict(eff_gops=1198.0, power_w=7.3,  latency_us=None, platform="XC7Z100"),
    "C-LSTM":    dict(eff_gops=714.3,  power_w=23.0, latency_us=9.1,  platform="XC7VX690T"),
    "E-RNN":     dict(eff_gops=783.1,  power_w=25.0, latency_us=8.3,  platform="XC7VX690T"),
    "BBS":       dict(eff_gops=2432.8, power_w=19.1, latency_us=2.4,  platform="GX1150"),
    "E-LSTM":    dict(eff_gops=403.3,  power_w=15.9, latency_us=23.9, platform="SX660"),
    "EdgeDRNN":  dict(eff_gops=20.2,   power_w=2.3,  latency_us=536.0, platform="XC7Z007S"),
}

SPARTUS_WALL_POWER_W = 8.4       # Table V
EDGE_SPARTUS_WALL_POWER_W = 2.3  # Table VI


def comparison_table(our: HWReport, power_w: float) -> Dict[str, Dict]:
    """Table V-style comparison: ratios of our modelled effective
    throughput / power efficiency to each prior accelerator."""
    ours_eff = our.batch1_throughput_gops
    ours_effW = ours_eff / power_w
    rows = {}
    for name, d in PRIOR_ACCELERATORS.items():
        rows[name] = {
            "eff_gops": d["eff_gops"],
            "throughput_ratio": ours_eff / d["eff_gops"],
            "power_eff_ratio": ours_effW / (d["eff_gops"] / d["power_w"]),
        }
    rows["ours"] = {"eff_gops": ours_eff, "throughput_ratio": 1.0,
                    "power_eff_ratio": 1.0,
                    "power_eff_gopsw": ours_effW}
    return rows
