"""The DeltaLSTM acoustic model (Spartus, arXiv:2108.02297): stacked
DeltaLSTM layers, an FC layer and a logit layer, served by the port's
``models/lstm_am.py``.

Its seeded weights are the benchmark's own copy of the initialisation
law and of CBTD's column-balanced magnitude prune (Alg. 1 of the
Spartus paper at alpha = 1), so that the port and the reference get the
same weights and neither made them:

* every matrix uniform in ``[-1/sqrt(H), 1/sqrt(H)]``, biases zero but
  the forget gate's (index 2 of the ``(i, g, f, o)`` order), which is 1;
  drawn from one ``torch.Generator`` on the device in one call;
* each layer's stacked ``[4H, D+H]`` matrix split into ``M`` subcolumns
  per column (row r goes to PE ``r % M``), each keeping its
  ``S - floor(S gamma)`` largest magnitudes (``S = 4H/M``; ties keep the
  lower index);
* the kept LSTM weights scaled by ``1/(1-gamma)``: without that gain the
  pruned random network never moves its hidden state by theta in a
  frame, and every logit of every layer past the first is constant.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.counting import kept_per_column
from bench.weights import cbtd_keep_mask

PORT_MODULE = "repro_torch.models.lstm_am"
PORT_CONFIG = "LSTMAMConfig"


def model_kwargs(cfg: dict) -> dict:
    if cfg["fc_dim"] != cfg["hidden_dim"]:
        raise ValueError("the port's FC layer is as wide as its LSTM")
    return dict(input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                n_layers=cfg["n_layers"], n_classes=cfg["n_classes"],
                delta=True, theta=cfg["theta"])


def input_dim(cfg: dict) -> int:
    return cfg["input_dim"]


def row_width(cfg: dict) -> int:
    """The first layer's encoder call takes the frame itself."""
    return cfg["input_dim"]


def ops_per_fired(cfg: dict) -> Dict[int, int]:
    """Every layer's fired delta multiplies its column's kept weights of
    the ``[4H, Q]`` gate stack, whatever the layer's input width."""
    h = cfg["hidden_dim"]
    per = 2 * kept_per_column(4 * h, cfg["gamma"], cfg["m"])
    return {cfg["input_dim"]: per, h: per}


def row_ops(cfg: dict) -> int:
    """Operations of one frame of one session beyond the gate products,
    counted from shapes: per layer the delta encoder (subtract, compare
    on D+H), ``dm += y`` (4H), five nonlinearities, ``c = f c + i g``
    and ``h = o tanh(c)`` (9H); then the FC layer, ReLU and logits."""
    d, h, c = cfg["input_dim"], cfg["hidden_dim"], cfg["n_classes"]
    total = 0
    for i in range(cfg["n_layers"]):
        q = (d if i == 0 else h) + h
        total += 2 * q + 4 * h + 9 * h
    return total + 2 * h * h + h + 2 * h * c + c


def sizes(cfg: dict):
    d, h, c = cfg["input_dim"], cfg["hidden_dim"], cfg["n_classes"]
    layers = [(d if i == 0 else h, h) for i in range(cfg["n_layers"])]
    return layers, h, c


def make_params(cfg: dict, seed: int, device) -> Dict:
    layers, h, c = sizes(cfg)
    bound = 1.0 / math.sqrt(h)
    shapes = []
    for d_in, _ in layers:
        shapes += [(4 * h, d_in), (4 * h, h)]
    shapes += [(h, h), (c, h)]
    total = sum(a * b for a, b in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device)
    flat = (flat * 2.0 - 1.0) * bound
    mats, at = [], 0
    for a, b in shapes:
        mats.append(flat[at:at + a * b].view(a, b))
        at += a * b
    gamma, m = cfg["gamma"], cfg["m"]
    gain = 1.0 / (1.0 - gamma)
    lstm = []
    for i, (d_in, _) in enumerate(layers):
        stacked = torch.cat([mats[2 * i], mats[2 * i + 1]], dim=1)
        stacked = stacked * cbtd_keep_mask(stacked, gamma, m) * gain
        b = torch.zeros((4, h), device=device)
        b[2] = 1.0
        lstm.append({"w_x": stacked[:, :d_in].contiguous(),
                     "w_h": stacked[:, d_in:].contiguous(), "b": b})
    zeros = lambda n: torch.zeros((n,), device=device)  # noqa: E731
    return {"lstm": lstm,
            "fcl": {"w": mats[-2].contiguous(), "b": zeros(h)},
            "logit": {"w": mats[-1].contiguous(), "b": zeros(c)}}
