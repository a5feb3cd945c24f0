"""LSTM acoustic model — the paper's own network family (Sec. V-B); port
of ``repro/models/lstm_am.py``.

LSTM layers, then a fully-connected layer of the same width and a logit
layer.  ``forward`` is the dense/Delta oracle and the training forward:
plain differentiable PyTorch ops that never call the serving kernels.
``cbtd_prune_stacks`` makes a servable column-balanced model;
``params_from_numpy`` brings the reference's parameters across
(``jax.random`` cannot be reproduced here, so the parity tests move
weights as numpy arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import (
    CBTDConfig,
    QuantConfig,
    apply_cbtd,
    delta_lstm_layer,
    fake_quant_act_ste,
    fake_quant_ste,
    init_lstm_params,
    lstm_layer,
    stacked_weight_matrix,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LSTMAMConfig:
    input_dim: int = 123
    hidden_dim: int = 1024
    n_layers: int = 2
    n_classes: int = 41          # CTC vocab (blank + phonemes)
    delta: bool = False          # DeltaLSTM (retrain phase) vs LSTM (pretrain)
    theta: float = 0.0           # delta threshold
    quant: QuantConfig = QuantConfig(enabled=False)

    @property
    def name(self) -> str:
        kind = "DeltaLSTM" if self.delta else "LSTM"
        return f"{kind}-{self.n_layers}L-{self.hidden_dim}H-UNI"


def init_params(generator: torch.Generator, cfg: LSTMAMConfig,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Params:
    """Seeded random parameters on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    layers = []
    d = cfg.input_dim
    for _ in range(cfg.n_layers):
        layers.append(init_lstm_params(generator, d, cfg.hidden_dim, dtype,
                                       device))
        d = cfg.hidden_dim
    bound = 1.0 / math.sqrt(cfg.hidden_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return ((u * 2.0 - 1.0) * bound).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    fcl = {"w": uniform((cfg.hidden_dim, cfg.hidden_dim)),
           "b": zeros(cfg.hidden_dim)}
    logit = {"w": uniform((cfg.n_classes, cfg.hidden_dim)),
             "b": zeros(cfg.n_classes)}
    return {"lstm": layers, "fcl": fcl, "logit": logit}


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of numpy arrays (e.g. the reference's params
    after ``jax.device_get``) -> the same structure of tensors on
    ``device``.  Floating arrays keep their dtype."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def n_params(params: Params) -> int:
    return sum(l.numel() for l in _tree.leaves(params))


def _maybe_quant_params(params: Params, cfg: LSTMAMConfig) -> Params:
    if not cfg.quant.enabled:
        return params

    def q(tree):
        if isinstance(tree, dict):
            return {k: q(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [q(v) for v in tree]
        return (fake_quant_ste(tree, cfg.quant.weight_bits)
                if tree.ndim == 2 else tree)

    return q(params)


def _maybe_quant_act(x: torch.Tensor, cfg: LSTMAMConfig) -> torch.Tensor:
    if not cfg.quant.enabled:
        return x
    return fake_quant_act_ste(x, cfg.quant.act_bits, cfg.quant.act_frac_bits)


def forward(params: Params, cfg: LSTMAMConfig, feats: torch.Tensor,
            collect_aux: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """feats [B, T, D] -> logits [B, T, n_classes]; aux carries per-layer
    delta occupancy when ``collect_aux``."""
    params = _maybe_quant_params(params, cfg)
    x = feats
    aux: Dict[str, Any] = {"layers": []}
    for lp in params["lstm"]:
        x = _maybe_quant_act(x, cfg)
        if cfg.delta:
            hs, _, layer_aux = delta_lstm_layer(lp, x, cfg.theta)
            if collect_aux:
                aux["layers"].append(layer_aux)
        else:
            hs = lstm_layer(lp, x)
        x = hs
    x = _maybe_quant_act(x, cfg)
    x = torch.relu(x @ params["fcl"]["w"].T + params["fcl"]["b"])
    x = _maybe_quant_act(x, cfg)
    return x @ params["logit"]["w"].T + params["logit"]["b"], aux


def cbtd_prune_stacks(params: Params, gamma: float, m: int) -> Params:
    """CBTD-prune every LSTM layer's stacked [4H, D+H] matrix (the matrix
    the serving engines CBCSC-pack) and split it back into w_x / w_h."""
    out = dict(params)
    layers = []
    for lp in params["lstm"]:
        w = apply_cbtd(stacked_weight_matrix(lp), gamma=gamma, m=m)
        d = lp["w_x"].shape[1]
        layers.append({**lp, "w_x": w[:, :d].contiguous(),
                       "w_h": w[:, d:].contiguous()})
    out["lstm"] = layers
    return out


def lstm_weight_layout() -> Dict[str, Any]:
    """CBTD layout: prune the recurrent stacks + FCL (paper Sec. V-C:
    'The CBTD was also applied to the FCL'), never the logit layer."""
    return {"w_x": CBTDConfig(), "w_h": CBTDConfig(), "fcl/w": CBTDConfig()}
