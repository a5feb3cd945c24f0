"""Seeded weights of a DeltaLSTM acoustic model, made on the device.

The benchmark's own copy of the initialisation law and of CBTD's
column-balanced magnitude prune (Alg. 1 of the Spartus paper at
alpha = 1), so that the port and the reference get the same weights and
neither made them:

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


def sizes(cfg: dict):
    d, h, c = cfg["input_dim"], cfg["hidden_dim"], cfg["n_classes"]
    layers = [(d if i == 0 else h, h) for i in range(cfg["n_layers"])]
    return layers, h, c


def cbtd_keep_mask(w: torch.Tensor, gamma: float, m: int) -> torch.Tensor:
    """Keep mask of ``w [R, Q]``: per subcolumn (rows r with r % m = pe)
    the ``S - floor(S gamma)`` largest |w|, ties to the lower row."""
    r, q = w.shape
    if r % m:
        raise ValueError(f"{r} rows do not split into {m} PEs")
    s = r // m
    sub = w.abs().reshape(s, m, q).permute(1, 0, 2)           # [M, S, Q]
    order = torch.argsort(sub, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)           # 0 = smallest
    keep = rank >= int(s * gamma)
    return keep.permute(1, 0, 2).reshape(r, q)


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
