"""Plain DeltaLSTM acoustic model (Spartus, arXiv:2108.02297, eqs. 3-8):
the reference that decides a cell's ``correct``.

It is handed the benchmark's weights (``bench/families/delta_lstm.py``)
and frames and derives the served model from them itself, as the
paper's accelerator stores it:

* each layer's stacked ``[4H, D+H]`` matrix on the int8 grid of a
  per-matrix power-of-two scale, ``2^ceil(log2(max|W| / 127))`` (Spartus
  keeps its CBCSC weights int8);
* with ``quant`` on, the layer input ``[x | h]`` and theta on the Q8.8
  grid (16 bits, 8 fractional, saturating) before the delta threshold;
* at most ``K = max(floor(Q * capacity_frac), 8)`` fired deltas a
  layer-step: the K largest magnitudes, ties to the lower column (the
  NZI list's capacity);
* the gate product ``y = W delta``, the delta memory ``dm += y``, gates
  (i, g, f, o), ``c = f c + i g``, ``h = o tanh(c)``; then
  ``relu(W_fc h + b)`` and the logit layer.

Precision ``"fp32"``: every product and sum of ``W delta`` is taken in
float64 and rounded once to float32, and each sigmoid and tanh likewise
(the correctly rounded float32 values, whatever the order of the sum);
the rest is float32 with TF32 off.  The controls, one step below what a
configuration states: ``"tf32"`` rounds every matrix operand to TF32's
10-bit mantissa (round to nearest even) and sums in float32;
``"int4"`` stores the LSTM weights on the int4 grid (power-of-two scale,
codes in [-7, 7]).
"""
from __future__ import annotations

from typing import Dict, List

import torch

PRECISIONS = ("fp32", "tf32", "int4")


def pow2_quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.clamp(w.abs().max().to(torch.float32), min=1e-8)
    scale = torch.exp2(torch.ceil(torch.log2(amax / qmax)))
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def q88(x: torch.Tensor) -> torch.Tensor:
    """Q8.8: 16-bit two's complement with 8 fractional bits."""
    return torch.clamp(torch.round(x * 256.0), -32768.0, 32767.0) / 256.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to
    even), as a TF32 tensor core reads its operands."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bias = 0xFFF + ((bits >> 13) & 1)
    out = ((bits + bias) & ~0x1FFF) & 0xFFFFFFFF
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def _matmul(a: torch.Tensor, b_t: torch.Tensor, precision: str
            ) -> torch.Tensor:
    """a [B, K] @ b_t.T (b_t [N, K]) in the reference's precision."""
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b_t).T
    return (a.double() @ b_t.double().T).float()


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.double()).float()


def served_layers(params: Dict, cfg: dict, precision: str) -> List[Dict]:
    bits = 4 if precision == "int4" else 8
    out = []
    for lp in params["lstm"]:
        w = torch.cat([lp["w_x"], lp["w_h"]], dim=1).float()
        q = w.shape[1]
        out.append({"w": pow2_quantize(w, bits), "b": lp["b"].float(),
                    "k": max(int(q * cfg["capacity_frac"]), 8)})
    return out


def clip_to_capacity(delta: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest |delta| of each row (ties to the lower
    index); rows with at most k fired entries pass unchanged."""
    if k >= delta.shape[-1]:
        return delta
    mag = torch.where(delta != 0, delta.abs(), torch.full_like(delta, -1.0))
    order = torch.argsort(-mag, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return torch.where(rank < k, delta, torch.zeros_like(delta))


@torch.no_grad()
def forward(params: Dict, cfg: dict, feats: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """feats [B, T, D] float32 on the device -> logits [B, T, C].  Rows
    are independent; frames past an utterance's end only pad."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _forward(params, cfg, feats, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(params, cfg, feats, precision):
    quant = bool(cfg.get("quant"))
    theta = torch.tensor(cfg["theta"], dtype=torch.float32)
    if quant:
        theta = q88(theta)
    theta = float(theta)
    layers = served_layers(params, cfg, precision)
    b, t_len, _ = feats.shape
    h_dim = cfg["hidden_dim"]
    dev = feats.device
    state = []
    for lay in layers:
        q = lay["w"].shape[1]
        state.append({"s_hat": torch.zeros((b, q), device=dev),
                      "c": torch.zeros((b, h_dim), device=dev),
                      "h": torch.zeros((b, h_dim), device=dev),
                      "dm": lay["b"].reshape(1, -1).repeat(b, 1)})
    hs = []
    for t in range(t_len):
        x = feats[:, t]
        for lay, st in zip(layers, state):
            s = torch.cat([x, st["h"]], dim=-1)
            if quant:
                s = q88(s)
            raw = s - st["s_hat"]
            fired = raw.abs() > theta
            delta = torch.where(fired, raw, torch.zeros_like(raw))
            st["s_hat"] = torch.where(fired, s, st["s_hat"])
            delta = clip_to_capacity(delta, lay["k"])
            st["dm"] = st["dm"] + _matmul(delta, lay["w"], precision)
            dm = st["dm"].view(b, 4, h_dim)
            i = _f64(torch.sigmoid, dm[:, 0])
            g = _f64(torch.tanh, dm[:, 1])
            f = _f64(torch.sigmoid, dm[:, 2])
            o = _f64(torch.sigmoid, dm[:, 3])
            st["c"] = f * st["c"] + i * g
            st["h"] = o * _f64(torch.tanh, st["c"])
            x = st["h"]
        hs.append(x)
    h = torch.stack(hs, dim=1).reshape(b * t_len, h_dim)
    mm = (lambda a, w: round_tf32(a) @ round_tf32(w).T) \
        if precision == "tf32" else (lambda a, w: a @ w.T)
    y = torch.relu(mm(h, params["fcl"]["w"]) + params["fcl"]["b"])
    y = mm(y, params["logit"]["w"]) + params["logit"]["b"]
    return y.reshape(b, t_len, -1)
