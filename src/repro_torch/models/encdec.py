"""Encoder-decoder transformer backbone (seamless-m4t-medium, audio);
port of ``repro/models/encdec.py``.

The modality frontend is a stub: the encoder takes precomputed
speech-frame embeddings [B, S, d].  The decoder is a causal transformer
with cross-attention to the encoder output.

Shapes contract:
  train:    enc frames [B, S, d] + dec tokens [B, S_dec]  -> CE loss
  prefill:  encoder forward over S frames + cross-KV build
  decode:   one decoder token against cached cross-KV (len S) + self cache
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.scan import remat as _remat
from repro_torch.models.scan import scan_layers

Params = Dict[str, Any]

DEC_SELF_CACHE = 1024  # decoder self-attention cache length


def _attn(gen, cfg: ArchConfig, dtype, device, lead):
    return L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, False, False, dtype, device, lead)


def init_enc_layers(gen, cfg: ArchConfig, dtype=torch.float32, device=None,
                    lead=()) -> Params:
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": _attn(gen, cfg, dtype, device, lead),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }


def init_dec_layers(gen, cfg: ArchConfig, dtype=torch.float32, device=None,
                    lead=()) -> Params:
    return {
        "self_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "self_attn": _attn(gen, cfg, dtype, device, lead),
        "cross_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "cross_attn": _attn(gen, cfg, dtype, device, lead),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Params:
    return {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), dtype, device) * 0.02,
        "enc_layers": init_enc_layers(gen, cfg, dtype, device,
                                      (cfg.n_enc_layers,)),
        "dec_layers": init_dec_layers(gen, cfg, dtype, device,
                                      (cfg.n_dec_layers,)),
        "enc_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab, False, dtype,
                                 device),
    }


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor,
           *, q_chunk: int = 0, remat: bool = False) -> torch.Tensor:
    """frames: [B, S, d] (frontend stub) -> encoder states [B, S, d]."""
    def body(carry, lp):
        x = carry
        h = L.attention_forward(
            lp["attn"], L.rms_norm(lp["attn_norm"], x), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, hd=cfg.hd, causal=False,
            q_chunk=q_chunk, rope_base=1e4,
        )
        x = x + h
        from repro_torch.distributed import hints
        x = x + L.swiglu(lp["mlp"], L.rms_norm(lp["mlp_norm"], x))
        return hints.constrain(x, "batch", "model", None), None

    if remat:
        body = _remat(body)
    x, _ = scan_layers(body, frames, params["enc_layers"])
    return L.rms_norm(params["enc_norm"], x)


def decode_train_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                        enc_out: torch.Tensor, *, q_chunk: int = 0,
                        remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder -> final hidden [B, S_dec, d]."""
    x = params["embed"][tokens.long()]

    def body(carry, lp):
        x = carry
        h = L.attention_forward(
            lp["self_attn"], L.rms_norm(lp["self_norm"], x),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            causal=True, q_chunk=q_chunk, rope_base=1e4,
        )
        x = x + h
        h = L.attention_forward(
            lp["cross_attn"], L.rms_norm(lp["cross_norm"], x),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            causal=False, q_chunk=q_chunk, kv_x=enc_out,
        )
        x = x + h
        from repro_torch.distributed import hints
        x = x + L.swiglu(lp["mlp"], L.rms_norm(lp["mlp_norm"], x))
        return hints.constrain(x, "batch", "model", None), None

    if remat:
        body = _remat(body)
    x, _ = scan_layers(body, x, params["dec_layers"])
    return L.rms_norm(params["final_norm"], x)


def decode_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, q_chunk: int = 0,
                 remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder -> logits [B, S_dec, V]."""
    x = decode_train_hidden(params, cfg, tokens, enc_out,
                            q_chunk=q_chunk, remat=remat)
    return x @ params["lm_head"]["w"].T


def build_cross_cache(params: Params, cfg: ArchConfig, enc_out: torch.Tensor):
    """Per-layer cross-attention K/V [L, B, S, Hkv, hd] (the prefill
    product)."""
    b, s, _ = enc_out.shape

    def per_layer(_, lp):
        k = L.linear(lp["cross_attn"]["k"], enc_out).reshape(
            b, s, cfg.n_kv_heads, cfg.hd)
        v = L.linear(lp["cross_attn"]["v"], enc_out).reshape(
            b, s, cfg.n_kv_heads, cfg.hd)
        return None, {"k": k, "v": v}

    return scan_layers(per_layer, None, params["dec_layers"])[1]


def init_cache(cfg: ArchConfig, batch: int, enc_len: int, dtype=torch.float32,
               device=None):
    """Self-attention cache of ``DEC_SELF_CACHE`` slots and a zero
    cross-KV of ``enc_len`` (the encoder length, where the other families
    take a cache length)."""
    lead = (cfg.n_dec_layers,)
    return {
        "self": L.init_kv_cache(batch, DEC_SELF_CACHE, cfg.n_kv_heads, cfg.hd,
                                dtype, device, lead),
        "cross": L.init_kv_cache(batch, enc_len, cfg.n_kv_heads, cfg.hd,
                                 dtype, device, lead),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor, cache):
    """One decoder token with cached cross-KV. tokens: [B, 1]."""
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    b = x.shape[0]

    def body(carry, scanned):
        lp, self_kc, cross_kc = scanned
        x = carry
        h, self_new = L.attention_decode_step(
            lp["self_attn"], L.rms_norm(lp["self_norm"], x), self_kc, pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
            rope_base=1e4,
        )
        x = x + h
        # cross-attention against the fixed encoder KV (no RoPE, no update)
        y = L.rms_norm(lp["cross_norm"], x)
        q = L.linear(lp["cross_attn"]["q"], y).reshape(b, 1, cfg.n_heads,
                                                       cfg.hd)
        enc_len = cross_kc["k"].shape[1]
        o = L._attn_block(q, L._expand_gqa(cross_kc["k"], cfg.n_heads),
                          L._expand_gqa(cross_kc["v"], cfg.n_heads),
                          torch.zeros((1,), dtype=torch.int32,
                                      device=x.device),
                          torch.arange(enc_len, device=x.device),
                          causal=False, window=0, kv_len=None)
        h = L.linear(lp["cross_attn"]["o"],
                     o.reshape(b, 1, cfg.n_heads * cfg.hd))
        x = x + h
        x = x + L.swiglu(lp["mlp"], L.rms_norm(lp["mlp_norm"], x))
        return x, self_new

    x, new_self = scan_layers(
        body, x, (params["dec_layers"], cache["self"], cache["cross"]))
    x = L.rms_norm(params["final_norm"], x)
    logits = x @ params["lm_head"]["w"].T
    return logits, {"self": new_self, "cross": cache["cross"], "pos": pos + 1}
