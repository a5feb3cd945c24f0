"""Shared transformer building blocks; port of ``repro/models/layers.py``.

Conventions (the reference's):
  * linear weights are stored ``[out, in]`` (y = x @ w.T), so CBTD and
    CBCSC apply to every linear of the zoo unchanged;
  * attention is grouped-query with optional QKV bias (qwen2), QK-norm
    (qwen3), sliding window (recurrentgemma), and a q-chunk loop so that
    a long prefill never holds an [S, S] score matrix;
  * sequence layers take and return [B, S, ...]; decode-step variants
    take a cache dict and a 0-d int position tensor on the cache's
    device, used only through tensor ops, so a decode step makes no host
    sync.

Initialisers draw from an explicit ``torch.Generator`` on its own device
and move the result to ``device``; ``lead`` prepends axes, so a stack of
``L`` layers is drawn as one ``[L, ...]`` leaf per weight.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Shape = Tuple[int, ...]

NEG_INF = -1e30


# -- init -------------------------------------------------------------------

def normal(gen: torch.Generator, shape: Shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).to(device)


def uniform(gen: torch.Generator, shape: Shape, lo: float, hi: float,
            device) -> torch.Tensor:
    """fp32 uniform in [lo, hi)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return (lo + (hi - lo) * u).to(device)


def init_linear(gen, d_in: int, d_out: int, bias: bool = False,
                dtype=torch.float32, device=None, scale: Optional[float] = None,
                lead: Shape = ()) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(gen, lead + (d_out, d_in), dtype, device) * scale}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].T
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d: int, dtype=torch.float32, device=None,
                 lead: Shape = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# -- RoPE ---------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 1e6) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  The two
    halves of the head are rotated against each other (not interleaved
    pairs); angles in fp32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freqs              # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------

def _expand_gqa(k: torch.Tensor, hq: int) -> torch.Tensor:
    """[B, S, Hkv, hd] -> [B, S, Hq, hd], each kv head repeated G times in
    a row (``jnp.repeat``: heads 0,0,1,1, not 0,1,0,1)."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def _attn_block(
    q: torch.Tensor,          # [B, Sq, H, hd]
    k: torch.Tensor,          # [B, Skv, H, hd]  (GQA pre-expanded)
    v: torch.Tensor,          # [B, Skv, H, hd]
    q_pos: torch.Tensor,      # [Sq] absolute positions of the q rows
    kv_pos: torch.Tensor,     # [Skv]
    causal: bool,
    window: int,
    kv_len: Optional[torch.Tensor],  # mask kv_pos >= kv_len (decode)
    apply_hints: bool = True,        # decode paths pre-constrain their layout
) -> torch.Tensor:
    """Masked softmax attention in fp32.  Masked scores are ``NEG_INF``,
    not ``-inf``, so a fully masked row gives uniform weights, not NaN."""
    from repro_torch.distributed import hints

    hd = q.shape[-1]
    if apply_hints:
        q, k, v = hints.shard_attn(q, k, v)
    scores = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * (hd ** -0.5)
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= kv_pos[None, :] < kv_len
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqt,bthd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,          # [B, Sq, Hq, hd]
    k: torch.Tensor,          # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 0,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA attention.  With ``q_chunk``, loops over query blocks so that
    peak memory is O(Sq/nc * Skv); with a window as well, each block
    reads only its [start, start + window + q_chunk) kv slab."""
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    k = _expand_gqa(k, hq)
    v = _expand_gqa(v, hq)
    kv_pos = torch.arange(skv, device=q.device)

    if q_chunk and sq > q_chunk and sq % q_chunk == 0:
        outs = []
        for ci in range(sq // q_chunk):
            qblk = q[:, ci * q_chunk:(ci + 1) * q_chunk]
            q_pos = q_offset + ci * q_chunk + torch.arange(q_chunk,
                                                           device=q.device)
            if window and skv > window + q_chunk:
                span = window + q_chunk
                start = min(max(ci * q_chunk + q_offset - window, 0),
                            skv - span)
                outs.append(_attn_block(
                    qblk, k[:, start:start + span], v[:, start:start + span],
                    q_pos, kv_pos[start:start + span], causal, window,
                    kv_len))
            else:
                outs.append(_attn_block(qblk, k, v, q_pos, kv_pos, causal,
                                        window, kv_len))
        return torch.cat(outs, dim=1)

    q_pos = q_offset + torch.arange(sq, device=q.device)
    return _attn_block(q, k, v, q_pos, kv_pos, causal, window, kv_len)


# -- attention module (params + cache) ---------------------------------------

def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int, hd: int,
                   qkv_bias: bool, qk_norm: bool, dtype=torch.float32,
                   device=None, lead: Shape = ()) -> Params:
    p = {
        "q": init_linear(gen, d_model, n_heads * hd, qkv_bias, dtype, device,
                         lead=lead),
        "k": init_linear(gen, d_model, n_kv_heads * hd, qkv_bias, dtype,
                         device, lead=lead),
        "v": init_linear(gen, d_model, n_kv_heads * hd, qkv_bias, dtype,
                         device, lead=lead),
        "o": init_linear(gen, n_heads * hd, d_model, False, dtype, device,
                         lead=lead),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device, lead)
        p["k_norm"] = init_rmsnorm(hd, dtype, device, lead)
    return p


def attention_forward(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, hd: int,
    causal: bool = True, window: int = 0, q_chunk: int = 0,
    rope_base: float = 1e6, positions: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention (or cross-attention when kv_x is given) over [B,S,d]."""
    b, s, _ = x.shape
    src = kv_x if kv_x is not None else x
    skv = src.shape[1]
    q = linear(p["q"], x).reshape(b, s, n_heads, hd)
    k = linear(p["k"], src).reshape(b, skv, n_kv_heads, hd)
    v = linear(p["v"], src).reshape(b, skv, n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if kv_x is None:  # RoPE only for self-attention
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        q = rope(q, torch.broadcast_to(pos, (s,)), rope_base)
        k = rope(k, torch.arange(skv, device=x.device), rope_base)
    out = attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    return linear(p["o"], out.reshape(b, s, n_heads * hd))


def attention_decode_step(
    p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
    pos: torch.Tensor, *, n_heads: int, n_kv_heads: int, hd: int,
    window: int = 0, rope_base: float = 1e6,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: [B, 1, d]; cache: {k,v: [B, S_cache, Hkv, hd]};
    pos: 0-d int tensor.  For windowed attention the cache is a ring
    buffer of size window.  Returns new k/v tensors; ``cache`` is not
    written.

    Without a window the slot is ``pos`` clamped to ``S_cache - 1``, as
    ``dynamic_update_slice`` clamps its start: a step at ``pos >=
    S_cache`` overwrites the last slot instead of failing."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    q = linear(p["q"], x).reshape(b, 1, n_heads, hd)
    k = linear(p["k"], x).reshape(b, 1, n_kv_heads, hd)
    v = linear(p["v"], x).reshape(b, 1, n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    q = rope(q, pos[None], rope_base)
    k = rope(k, pos[None], rope_base)

    slot = pos % s_cache if window else pos
    index = torch.clamp(slot, 0, s_cache - 1).reshape(1).long()
    new_k = cache["k"].index_copy(1, index, k)
    new_v = cache["v"].index_copy(1, index, v)

    from repro_torch.distributed import hints

    ke = _expand_gqa(new_k, n_heads)
    ve = _expand_gqa(new_v, n_heads)
    q, ke, ve = hints.shard_attn_decode(q, ke, ve, n_kv_heads)
    kv_pos = torch.arange(s_cache, device=x.device)
    if window:
        # ring buffer: recover absolute positions of each slot to mask
        ring_pos = torch.where(kv_pos <= slot, pos - slot + kv_pos,
                               pos - slot - s_cache + kv_pos)
        valid = ring_pos >= torch.clamp(pos - window + 1, min=0)
        scores = torch.einsum("bqhd,bthd->bhqt", q.float(),
                              ke.float()) * (hd ** -0.5)
        scores = scores.masked_fill(~valid[None, None, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqt,bthd->bqhd", probs, ve.float()).to(x.dtype)
    else:
        out = _attn_block(q, ke, ve, pos[None], kv_pos, causal=False,
                          window=0, kv_len=pos + 1, apply_hints=False)
    y = linear(p["o"], out.reshape(b, 1, n_heads * hd))
    return y, {"k": new_k, "v": new_v}


def init_kv_cache(batch: int, s_cache: int, n_kv_heads: int, hd: int,
                  dtype=torch.float32, device=None,
                  lead: Shape = ()) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, s_cache, n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# -- MLP ----------------------------------------------------------------------

def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device=None, lead: Shape = ()) -> Params:
    return {
        "gate": init_linear(gen, d_model, d_ff, False, dtype, device,
                            lead=lead),
        "up": init_linear(gen, d_model, d_ff, False, dtype, device, lead=lead),
        "down": init_linear(gen, d_ff, d_model, False, dtype, device,
                            lead=lead),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


# -- MoE ------------------------------------------------------------------------

def init_moe(gen, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device=None, lead: Shape = ()) -> Params:
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    return {
        "router": init_linear(gen, d_model, n_experts, False, dtype, device,
                              lead=lead),
        "gate": normal(gen, lead + (n_experts, d_ff, d_model), dtype,
                       device) * s_in,
        "up": normal(gen, lead + (n_experts, d_ff, d_model), dtype,
                     device) * s_in,
        "down": normal(gen, lead + (n_experts, d_model, d_ff), dtype,
                       device) * s_ff,
    }


def lax_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the largest ``k`` values in
    descending order, a tie going to the lower index (``torch.topk``
    promises no order among ties; a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(eids: torch.Tensor, top_k: int, cap: int):
    """eids: [B, S, K] -> per row, over the S*K (token, k) pairs in a
    stable sort by expert id: (order, dest, keep, token_of).  The rank
    within an expert's segment is its capacity slot; ranks >= cap are
    dropped."""
    b, s, _ = eids.shape
    flat_e = eids.reshape(b, s * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(s * top_k, device=eids.device) - seg_start
    dest = sorted_e * cap + pos
    keep = pos < cap
    token_of = order // top_k
    return order, dest, keep, token_of


def moe_forward(p: Params, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k token-choice MoE with static per-row capacity (Switch
    semantics: overflow beyond capacity drops tokens).

    Dispatch is sort-based per batch row; a dropped pair is written to a
    sentinel row past the [E*C] buffer and discarded (the reference's
    ``mode="drop"`` scatter).  The combine gathers each token's K
    weighted expert outputs back to their (token, k) places and sums
    over k: a fixed order on every device, where the reference's
    ``.at[token_of].add`` scatter-adds them in expert order."""
    from repro_torch.distributed import hints

    b, s, d = x.shape
    e = p["router"]["w"].shape[0]

    # long sequences dispatch in sequence blocks: per-(row, block) sort +
    # capacity keeps the dispatch buffers bounded; the fused (B*nb) dim is
    # pinned to batch sharding
    block = 2048
    if s > block and s % block == 0:
        nb = s // block
        xb = hints.constrain(x.reshape(b * nb, block, d), "batch", None, None)
        yb = moe_forward(p, xb, top_k=top_k, capacity_factor=capacity_factor)
        yb = hints.constrain(yb, "batch", None, None)
        return yb.reshape(b, s, d)

    cap = int(max(1, round(s * top_k / e * capacity_factor)))

    logits = linear(p["router"], x.float())                        # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eids = lax_top_k(probs, top_k)             # [B, S, K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    order, dest, keep, token_of = _routing(eids, top_k, cap)
    rows = torch.arange(b, device=x.device)[:, None]
    slot = torch.where(keep, dest, e * cap)                        # sentinel
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((rows, slot), x[rows, token_of])
    buf = buf[:, :e * cap].reshape(b, e, cap, d)                   # [B,E,C,d]
    buf = hints.constrain(buf, "batch", "model", None, None)

    act = F.silu(torch.einsum("becd,efd->becf", buf, p["gate"])) * torch.einsum(
        "becd,efd->becf", buf, p["up"])
    o = torch.einsum("becf,edf->becd", act, p["down"])
    o = hints.constrain(o, "batch", "model", None, None).reshape(b, e * cap, d)

    gathered = torch.where(keep[..., None],
                           o[rows, torch.where(keep, dest, 0)], 0.0)
    gate_sorted = torch.gather(gate_vals.reshape(b, s * top_k), 1, order)
    weighted = gathered * gate_sorted[..., None].to(o.dtype)       # sorted order
    # back to (token, k) order, then the sum over k
    unsorted = torch.empty_like(weighted).index_put_(
        (rows, order), weighted)
    return unsorted.reshape(b, s, top_k, d).sum(dim=2)


def moe_aux_loss(p: Params, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f*P)."""
    b, s, d = x.shape
    e = p["router"]["w"].shape[0]
    logits = linear(p["router"], x.reshape(-1, d).float())
    probs = torch.softmax(logits, dim=-1)
    _, eids = lax_top_k(probs, top_k)
    f = torch.mean(F.one_hot(eids, e).float(), dim=(0, 1))
    pmean = torch.mean(probs, dim=0)
    return e * torch.sum(f * pmean)
