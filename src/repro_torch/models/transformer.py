"""Decoder-only transformer LM (dense + MoE; the VLM backbone) — qwen2,
qwen3, granite-34b, internlm2, the pixtral backbone, granite-moe and
olmoe; port of ``repro/models/transformer.py``.

Layers are stacked along a leading ``[L]`` axis and run by
``scan_layers``, optionally rematerialised for training.  Decode steps
loop over (layer params, layer KV cache) pairs and return the updated
stacked cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.scan import remat as _remat
from repro_torch.models.scan import scan_layers

Params = Dict[str, Any]


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Params:
    lead = (cfg.n_layers,)
    layers = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": L.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.qkv_bias, cfg.qk_norm, dtype, device, lead),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
    }
    if cfg.family == "moe":
        layers["moe"] = L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   dtype, device, lead)
    else:
        layers["mlp"] = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device, lead)
    params = {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), dtype, device) * 0.02,
        "layers": layers,
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab, False,
                                          dtype, device)
    return params


def _mlp(lp: Params, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "moe":
        return L.moe_forward(lp["moe"], y, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
    return L.swiglu(lp["mlp"], y)


def _layer_fwd(lp: Params, x: torch.Tensor, cfg: ArchConfig,
               q_chunk: int) -> torch.Tensor:
    h = L.attention_forward(
        lp["attn"], L.rms_norm(lp["attn_norm"], x),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
        causal=True, window=cfg.attn_window, q_chunk=q_chunk,
    )
    x = x + h
    from repro_torch.distributed import hints
    # sequence-shard the residual checkpoint (Megatron-style SP)
    return hints.constrain(x + _mlp(lp, L.rms_norm(lp["mlp_norm"], x), cfg),
                           "batch", "model", None)


def head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"]


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def forward_hidden(
    params: Params,
    cfg: ArchConfig,
    tokens: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    *,
    q_chunk: int = 0,
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence forward -> final hidden states [B, S, d]."""
    x = embed(params, tokens) if inputs_embeds is None else inputs_embeds

    def body(carry, lp):
        return _layer_fwd(lp, carry, cfg, q_chunk), None

    if remat:
        body = _remat(body)
    x, _ = scan_layers(body, x, params["layers"])
    return L.rms_norm(params["final_norm"], x)


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    *,
    q_chunk: int = 0,
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V]."""
    x = forward_hidden(params, cfg, tokens, inputs_embeds,
                       q_chunk=q_chunk, remat=remat)
    from repro_torch.distributed import hints
    return hints.constrain(x @ head_weight(params, cfg).T,
                           "batch", None, "model")


def init_cache(cfg: ArchConfig, batch: int, s_cache: int, dtype=torch.float32,
               device=None):
    """Stacked KV cache [L, B, S, Hkv, hd] x2 + a 0-d int32 position."""
    return {"kv": L.init_kv_cache(batch, s_cache, cfg.n_kv_heads, cfg.hd,
                                  dtype, device, lead=(cfg.n_layers,)),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(
    params: Params,
    cfg: ArchConfig,
    tokens: Optional[torch.Tensor],           # [B, 1] (or None with embeds)
    cache,
    inputs_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """One token step -> (logits [B, 1, V], new cache)."""
    pos = cache["pos"]
    x = embed(params, tokens) if inputs_embeds is None else inputs_embeds

    def body(carry, scanned):
        lp, kc = scanned
        x = carry
        h, kc_new = L.attention_decode_step(
            lp["attn"], L.rms_norm(lp["attn_norm"], x), kc, pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            window=cfg.attn_window,
        )
        x = x + h
        return x + _mlp(lp, L.rms_norm(lp["mlp_norm"], x), cfg), kc_new

    x, new_kv = scan_layers(body, x, (params["layers"], cache["kv"]))
    x = L.rms_norm(params["final_norm"], x)
    logits = x @ head_weight(params, cfg).T
    return logits, {"kv": new_kv, "pos": pos + 1}


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -torch.mean(ll)


def chunked_ce_loss(x: torch.Tensor, head_w: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """CE over a vocab head without holding [B, S, V] logits: a loop over
    sequence chunks, each chunk's logits recomputed in the backward pass.
    A sequence that is one chunk, or not a multiple of it, takes the
    full-logit path."""
    from repro_torch.distributed import hints

    b, s, d = x.shape
    if s % chunk or s == chunk:
        return ce_loss(hints.constrain(x @ head_w.T, "batch", None, "model"),
                       targets)
    nc = s // chunk
    xs = x.reshape(b, nc, chunk, d).transpose(0, 1)
    ts = targets.reshape(b, nc, chunk).transpose(0, 1)

    def body(acc, inp):
        xc, tc = inp
        logits = hints.constrain(xc @ head_w.T, "batch", None,
                                 "model").float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
        return acc + torch.sum(lse - tgt), None

    total, _ = scan_layers(_remat(body), torch.zeros(
        (), dtype=torch.float32, device=x.device), (xs, ts))
    return total / (b * s)
