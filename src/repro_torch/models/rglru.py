"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU recurrent
blocks + local (sliding-window, MQA) attention in a 2:1 pattern; port of
``repro/models/rglru.py``.

The reference evaluates the RG-LRU with ``jax.lax.associative_scan``.
PyTorch has no such op: ``rglru_scan`` runs the same linear recurrence as
a Hillis-Steele scan (log2(S) steps of one shifted combine each), whose
products and sums are grouped in another order than XLA's, so its
results agree with the reference's to rounding, not bit for bit.
Decode is O(1) state.

Layer pattern: ("rglru", "rglru", "attn") repeated; the remainder layers
(38 = 12*3 + 2) are appended as unstacked blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba2 import causal_conv
from repro_torch.models.scan import remat as _remat
from repro_torch.models.scan import scan_layers

Params = Dict[str, Any]

LRU_C = 8.0  # Griffin's fixed exponent scale


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# -- RG-LRU core ---------------------------------------------------------------

def init_rglru(gen, cfg: ArchConfig, dtype=torch.float32, device=None,
               lead=()) -> Params:
    w = _lru_width(cfg)
    # Lambda raw-init so a = exp(-c*softplus(L)) lands in [0.9, 0.999]
    u = L.uniform(gen, lead + (w,), 0.9, 0.999, device)
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))  # inverse softplus
    return {
        "in_x": L.init_linear(gen, cfg.d_model, w, False, dtype, device,
                              lead=lead),
        "in_y": L.init_linear(gen, cfg.d_model, w, False, dtype, device,
                              lead=lead),
        "conv_w": L.normal(gen, lead + (4, w), dtype, device) * 0.2,
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=device),
        "gate_a": L.init_linear(gen, w, w, True, dtype, device, lead=lead),
        "gate_i": L.init_linear(gen, w, w, True, dtype, device, lead=lead),
        "lambda_raw": lam,
        "out": L.init_linear(gen, w, cfg.d_model, False, dtype, device,
                             lead=lead),
    }


def _lru_coeffs(p: Params, x: torch.Tensor):
    """x: [..., W] -> (a, b) of the recurrence h = a*h_prev + b."""
    r = torch.sigmoid(L.linear(p["gate_a"], x).float())
    i = torch.sigmoid(L.linear(p["gate_i"], x).float())
    log_a = -LRU_C * F.softplus(p["lambda_raw"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * x.float())
    return a, b


def rglru_scan(p: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence over [B, S, W] -> (h [B,S,W], h_last)."""
    a, b = _lru_coeffs(p, x)
    if h0 is not None:
        # fold the carried state into the first step's offset
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    # Hillis-Steele: after the step at shift k, (a_t, b_t) composes the
    # steps t-2k+1..t; the combine of (earlier, later) is
    # (a1*a2, a2*b1 + b2), with (1, 0) past the start
    s = a.shape[1]
    k = 1
    while k < s:
        a_prev = F.pad(a[:, :-k], (0, 0, k, 0), value=1.0)
        b_prev = F.pad(b[:, :-k], (0, 0, k, 0))
        b = a * b_prev + b
        a = a * a_prev
        k *= 2
    return b.to(x.dtype), b[:, -1]


def rglru_block(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full Griffin recurrent block over [B, S, d]."""
    xb = L.linear(p["in_x"], x)
    yb = _gelu(L.linear(p["in_y"], x))
    xb = causal_conv(xb, p["conv_w"], p["conv_b"])
    h, _ = rglru_scan(p, xb)
    return L.linear(p["out"], h * yb)


def rglru_decode(p: Params, cfg: ArchConfig, x: torch.Tensor, state):
    """x: [B, 1, d]; state: {conv: [B,3,W], h: [B,W]}."""
    xb = L.linear(p["in_x"], x[:, 0])
    yb = _gelu(L.linear(p["in_y"], x[:, 0]))
    win = torch.cat([state["conv"], xb[:, None]], dim=1)         # [B,4,W]
    xc = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    a, b = _lru_coeffs(p, xc)
    h = a * state["h"].float() + b
    out = L.linear(p["out"], (h.to(x.dtype) * yb))[:, None]
    return out, {"conv": win[:, 1:], "h": h}


# -- block assembly --------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, kind: str, dtype=torch.float32,
               device=None, lead=()) -> Params:
    p = {"mix_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
         "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
         "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              lead)}
    if kind == "attn":
        p["attn"] = L.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            False, False, dtype, device, lead)
    else:
        p["rglru"] = init_rglru(gen, cfg, dtype, device, lead)
    return p


def block_forward(bp: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
                  q_chunk: int = 0) -> torch.Tensor:
    y = L.rms_norm(bp["mix_norm"], x)
    if kind == "attn":
        h = L.attention_forward(
            bp["attn"], y, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            hd=cfg.hd, causal=True, window=cfg.attn_window, q_chunk=q_chunk,
            rope_base=1e4,
        )
    else:
        h = rglru_block(bp["rglru"], cfg, y)
    x = x + h
    from repro_torch.distributed import hints
    x = x + L.swiglu(bp["mlp"], L.rms_norm(bp["mlp_norm"], x))
    return hints.constrain(x, "batch", "model", None)


def _layout(cfg: ArchConfig):
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    rest = tuple(pat[i] for i in range(cfg.n_layers - n_super * len(pat)))
    return pat, n_super, rest


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Params:
    pat, n_super, rest = _layout(cfg)
    return {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), dtype, device) * 0.02,
        "supers": {f"b{i}_{kind}": init_block(gen, cfg, kind, dtype, device,
                                              (n_super,))
                   for i, kind in enumerate(pat)},
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab, False, dtype,
                                 device),
        "rest": [init_block(gen, cfg, kind, dtype, device) for kind in rest],
    }


def forward_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   *, q_chunk: int = 0, remat: bool = False) -> torch.Tensor:
    pat, n_super, rest = _layout(cfg)
    x = params["embed"][tokens.long()]

    def body(carry, sp):
        x = carry
        for i, kind in enumerate(pat):
            x = block_forward(sp[f"b{i}_{kind}"], cfg, kind, x, q_chunk)
        return x, None

    if remat:
        body = _remat(body)
    x, _ = scan_layers(body, x, params["supers"])
    for bp, kind in zip(params["rest"], rest):
        x = block_forward(bp, cfg, kind, x, q_chunk)
    return L.rms_norm(params["final_norm"], x)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            *, q_chunk: int = 0, remat: bool = False) -> torch.Tensor:
    x = forward_hidden(params, cfg, tokens, q_chunk=q_chunk, remat=remat)
    return x @ params["lm_head"]["w"].T


# -- decode ----------------------------------------------------------------------

def _block_cache(cfg: ArchConfig, kind: str, batch: int, dtype, device,
                 lead=()):
    w = _lru_width(cfg)
    if kind == "attn":
        cache_len = cfg.attn_window or 2048
        return L.init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.hd,
                               dtype, device, lead)
    return {"conv": torch.zeros(lead + (batch, 3, w), dtype=dtype,
                                device=device),
            "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device)}


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    pat, n_super, rest = _layout(cfg)
    return {
        "supers": {f"b{i}_{kind}": _block_cache(cfg, kind, batch, dtype,
                                                device, (n_super,))
                   for i, kind in enumerate(pat)},
        "rest": [_block_cache(cfg, kind, batch, dtype, device)
                 for kind in rest],
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _block_decode(bp, cfg, kind, x, bc, pos):
    y = L.rms_norm(bp["mix_norm"], x)
    if kind == "attn":
        h, bc = L.attention_decode_step(
            bp["attn"], y, bc, pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            window=cfg.attn_window or 2048, rope_base=1e4,
        )
    else:
        h, bc = rglru_decode(bp["rglru"], cfg, y, bc)
    x = x + h
    x = x + L.swiglu(bp["mlp"], L.rms_norm(bp["mlp_norm"], x))
    return x, bc


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor, cache):
    pat, n_super, rest = _layout(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()]

    def body(carry, scanned):
        sp, sc = scanned
        x = carry
        new_sc = {}
        for i, kind in enumerate(pat):
            name = f"b{i}_{kind}"
            x, new_sc[name] = _block_decode(sp[name], cfg, kind, x, sc[name],
                                            pos)
        return x, new_sc

    x, new_supers = scan_layers(body, x, (params["supers"], cache["supers"]))
    new_rest = []
    for bp, bc, kind in zip(params["rest"], cache["rest"], rest):
        x, nbc = _block_decode(bp, cfg, kind, x, bc, pos)
        new_rest.append(nbc)
    x = L.rms_norm(params["final_norm"], x)
    logits = x @ params["lm_head"]["w"].T
    return logits, {"supers": new_supers, "rest": new_rest, "pos": pos + 1}
