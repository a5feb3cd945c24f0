"""Spartus serving engine: streaming DeltaLSTM inference over CBCSC
weights — port of ``repro/serving/engine.py``.

Per step and per layer:
  IPU   -> kernels.ops.delta_encode_step (thresholded Δ, reference update)
  CTRL  -> kernels.ops.select_active_columns (fixed-capacity NZI list)
  MACs  -> kernels.ops.stsp_spmv      (CBCSC spatio-temporal SpMxSpV)
  HPE   -> kernels.ops.lstm_pointwise_step (Δ-memory update, gates, cell)

There is no ``use_pallas`` switch: the engine's device decides.  On
``cuda`` (the default) every stage above that was a Pallas kernel in the
reference runs a hand-written CUDA kernel; on ``device="cpu"`` it runs
the kernels' plain PyTorch versions.  Asking for CUDA without a card
raises.

Packing (`pack_lstm_layer`) runs once on the host, so the CPU and CUDA
engines of one model hold bit-identical weights; the packed arrays then
live on the engine's device.  In the quantized pack the int8 payloads
simply stay int8 tensors — eager PyTorch folds nothing, so the
reference's optimization barriers have no counterpart here.

`SpartusEngine` is the batch-1 parity oracle: a Python loop per frame
with host syncs for telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import (
    DeviceLike,
    as_tensor,
    require_full_fp32_matmul,
    resolve_device,
)
from repro_torch.core import (
    CBCSC, blen_for, cbcsc_decode, cbcsc_encode, int8_pack,
    stacked_weight_matrix,
)
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models.lstm_am import LSTMAMConfig


@dataclasses.dataclass
class PackedLayer:
    enc: CBCSC                 # CBCSC arrays (values int8-dequantized)
    scale: torch.Tensor        # int8 weight scale (0-d float32)
    bias: torch.Tensor         # [4, H] initial delta memories
    input_dim: int
    hidden_dim: int
    capacity: int              # NZI list capacity
    pack_overflow: int = 0     # nonzeros clipped enforcing BLEN at pack time
    # [D+H, 4H] pre-transposed dense mirror (dense SpMV route): float32
    # in the fp32 pack, int8 in the quantized pack; the dense-mirror
    # kernel widens it in registers (see ops._mirror_matmul)
    w_dense_t: Optional[torch.Tensor] = None

    def to(self, device: torch.device) -> "PackedLayer":
        return dataclasses.replace(
            self, enc=self.enc.to(device), scale=self.scale.to(device),
            bias=self.bias.to(device),
            w_dense_t=(None if self.w_dense_t is None
                       else self.w_dense_t.to(device)))


@dataclasses.dataclass
class EngineConfig:
    theta: float = 0.1
    gamma: float = 0.9375
    m: int = 64                # PEs per column (CBCSC granularity)
    capacity_frac: float = 0.5  # NZI capacity as fraction of columns
    quant_bits: int = 8
    # "auto" routes layers with S*(1-gamma) >= 1 to the dense mirror
    # (ops.spmv_use_dense_gather); "scatter" forces the CBCSC scatter
    # kernel, "dense" forces the mirror.
    spmv_path: str = "auto"
    # Quantized serving: int8 payloads at rest, dequantized on the SpMV
    # output, and the delta threshold on the Qm.n activation grid.  None
    # or enabled=False is the fp32 path.
    quant: Optional[QuantConfig] = None


def active_quant(cfg: EngineConfig) -> Optional[QuantConfig]:
    """The engine's quantization config iff quantization is actually on."""
    q = cfg.quant
    return q if (q is not None and q.enabled) else None


def act_kwargs(cfg: EngineConfig) -> Dict[str, int]:
    quant = active_quant(cfg)
    if quant is None:
        return {}
    return {"act_bits": quant.act_bits, "act_frac_bits": quant.act_frac_bits}


def pack_lstm_layer(params: Dict[str, Any], cfg: EngineConfig) -> PackedLayer:
    """Export one (CBTD-pruned) LSTM layer to the serving format, on the
    device of ``params``.  BLEN is enforced at ``blen_for(gamma)``; the
    clipped overflow count is ``pack_overflow``."""
    if cfg.spmv_path not in ("auto", "scatter", "dense"):
        raise ValueError(f"spmv_path must be 'auto', 'scatter' or 'dense', "
                         f"got {cfg.spmv_path!r}")
    w = stacked_weight_matrix(params)              # [4H, D+H]
    q8, scale = int8_pack(w)
    wq = q8.to(torch.float32) * scale              # dequantized int8 grid
    wq = wq * (w != 0)                             # keep pruned zeros exact
    h4, n_cols = wq.shape
    m = cfg.m
    while h4 % m:
        m //= 2
    enc = cbcsc_encode(wq, m, blen=blen_for(h4, m, cfg.gamma),
                       on_overflow="clip")
    overflow = int((wq != 0).sum() - enc.valid.sum())
    s = enc.s
    w_dense_t = None
    if cfg.spmv_path == "dense" or (
        cfg.spmv_path == "auto" and ops.spmv_use_dense_gather(s, cfg.gamma)
    ):
        # decoded from the clipped CBCSC arrays so every route computes
        # from identical weights; stored in the GEMM's contraction layout
        w_dense_t = cbcsc_decode(enc, torch.float32).T.contiguous()
    if active_quant(cfg) is not None:
        # the fp32 payload is on the int8 grid (pow2 scale): dividing back
        # is exact, and y*scale on the SpMV output reproduces the fp32 path
        lidx = enc.lidx.to(torch.int8) if s <= 128 else enc.lidx
        enc = dataclasses.replace(
            enc, val=torch.round(enc.val / scale).to(torch.int8), lidx=lidx)
        if w_dense_t is not None:
            w_dense_t = torch.round(w_dense_t / scale).to(torch.int8)
    return PackedLayer(
        enc=enc, scale=scale, bias=params["b"],
        input_dim=w.shape[1] - params["w_h"].shape[1],
        hidden_dim=params["w_h"].shape[1],
        capacity=max(int(n_cols * cfg.capacity_frac), 8),
        pack_overflow=overflow, w_dense_t=w_dense_t,
    )


def tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu") for k, v in tree.items()}


class PackedSpartusModel:
    """CBCSC export + weight accounting shared by the batch-1 engine and
    the continuous-batching engine."""

    def __init__(self, am_params: Dict[str, Any], am_cfg: LSTMAMConfig,
                 cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        require_full_fp32_matmul(self.device)
        self.cfg = cfg
        self.layers = [pack_lstm_layer(_host(lp), cfg).to(self.device)
                       for lp in am_params["lstm"]]
        self.fcl = {k: v.to(self.device) for k, v in am_params["fcl"].items()}
        self.logit = {k: v.to(self.device)
                      for k, v in am_params["logit"].items()}
        self.am_cfg = am_cfg

    @property
    def input_dim(self) -> int:
        return self.layers[0].input_dim

    @property
    def n_classes(self) -> int:
        return self.logit["w"].shape[0]

    @property
    def n_cols(self) -> List[int]:
        """Stacked-matrix column count per layer (telemetry reduction)."""
        return [l.input_dim + l.hidden_dim for l in self.layers]

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """FCL + ReLU + logit layer: h [..., H] -> logits [..., C]."""
        h = torch.relu(h @ self.fcl["w"].T + self.fcl["b"])
        return h @ self.logit["w"].T + self.logit["b"]

    def weight_sparsity(self) -> float:
        """Fraction of zero weights in the packed layers."""
        dense = sum(l.enc.h * l.enc.q for l in self.layers)
        nnz = sum(int(l.enc.valid.sum()) for l in self.layers)
        return 1.0 - nnz / dense

    def pack_overflow_count(self) -> int:
        """Nonzeros clipped across layers enforcing BLEN at pack time."""
        return sum(l.pack_overflow for l in self.layers)

    def weight_bytes(self) -> int:
        """Bytes of packed weight memory at rest: CBCSC payloads (val +
        lidx + valid), dense mirrors (4 bytes a weight in the fp32 pack,
        1 in the int8 pack), biases, scales and the head."""
        total = 0
        for l in self.layers:
            total += tensor_nbytes(l.enc.val) + tensor_nbytes(l.enc.lidx)
            total += tensor_nbytes(l.enc.valid) + tensor_nbytes(l.bias)
            total += tensor_nbytes(l.scale)
            if l.w_dense_t is not None:
                total += tensor_nbytes(l.w_dense_t)
        for p in (self.fcl, self.logit):
            total += sum(tensor_nbytes(a) for a in p.values())
        return total

    def weight_payload_bytes(self) -> int:
        """CBCSC val/lidx streams + dense mirrors only (the paper's WMEM)."""
        total = 0
        for l in self.layers:
            total += tensor_nbytes(l.enc.val) + tensor_nbytes(l.enc.lidx)
            if l.w_dense_t is not None:
                total += tensor_nbytes(l.w_dense_t)
        return total


class LayerState:
    """Mutable per-session state of one DeltaLSTM layer (x̂/ĥ/c/h/DM)."""

    def __init__(self, layer: PackedLayer):
        d, h = layer.input_dim, layer.hidden_dim
        kw = dict(dtype=torch.float32, device=layer.bias.device)
        self.s_hat = torch.zeros((d + h,), **kw)   # concatenated x̂ / ĥ
        self.c = torch.zeros((h,), **kw)
        self.h = torch.zeros((h,), **kw)
        self.dm = layer.bias.to(torch.float32).reshape(-1).clone()   # [4H]


def _step_layer(layer: PackedLayer, state: LayerState, x: torch.Tensor,
                cfg: EngineConfig) -> Tuple[torch.Tensor, Dict[str, int]]:
    """One streaming step of one layer.  x: [D] -> h: [H]."""
    wscale = layer.scale if active_quant(cfg) is not None else None
    # the pool's fused IPU and HPE stages at B=1, state updated in place
    delta, nnz = ops.delta_encode_step(x.contiguous()[None], state.h[None],
                                       state.s_hat[None], cfg.theta,
                                       **act_kwargs(cfg))
    delta = delta[0]
    if layer.w_dense_t is not None:
        # B=1 leg of the batched dense-mirror computation
        y, dropped = ops.delta_spmv_dense_topk_batch(
            layer.w_dense_t, delta[None], layer.capacity, scale=wscale)
        y, dropped = y[0], dropped[0]
    else:
        idx, vals, dropped = ops.select_active_columns(delta, layer.capacity)
        y = ops.stsp_spmv(layer.enc.val, layer.enc.lidx, idx, vals,
                          s=layer.enc.s, scale=wscale)
    h_new = ops.lstm_pointwise_step(state.dm[None], y[None], state.c[None],
                                    state.h[None])[0]
    stats = {"nnz": int(nnz[0]), "dropped": int(dropped),
             "n_cols": int(delta.shape[0])}
    return h_new, stats


class SpartusEngine(PackedSpartusModel):
    """Multi-layer streaming engine with per-step sparsity telemetry."""

    def __init__(self, am_params: Dict[str, Any], am_cfg: LSTMAMConfig,
                 cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        super().__init__(am_params, am_cfg, cfg, device)
        self.telemetry: List[Dict[str, int]] = []

    def new_session(self) -> List[LayerState]:
        return [LayerState(l) for l in self.layers]

    def step(self, session: List[LayerState], x: torch.Tensor) -> torch.Tensor:
        """One frame through the whole AM -> logits [n_classes]."""
        h = x
        for li, (layer, st) in enumerate(zip(self.layers, session)):
            h, stats = _step_layer(layer, st, h, self.cfg)
            stats["layer"] = li
            self.telemetry.append(stats)
        return self.head(h)

    def run_utterance(self, feats) -> torch.Tensor:
        """feats [T, D] (numpy or tensor) -> logits [T, n_classes] on the
        engine's device (batch-1 streaming)."""
        feats = as_tensor(feats, torch.float32, self.device)
        session = self.new_session()
        return torch.stack([self.step(session, feats[t])
                            for t in range(feats.shape[0])])

    # -- telemetry -> hardware model -----------------------------------------

    def measured_sparsity(self) -> Dict[str, float]:
        if not self.telemetry:
            return {}
        nnz = np.array([t["nnz"] for t in self.telemetry], np.float64)
        cols = np.array([t["n_cols"] for t in self.telemetry], np.float64)
        dropped = np.array([t["dropped"] for t in self.telemetry], np.float64)
        return {
            "temporal_sparsity": float(1.0 - (nnz / cols).mean()),
            "capacity_overflow_rate": float((dropped > 0).mean()),
            "mean_active_columns": float(nnz.mean()),
        }
