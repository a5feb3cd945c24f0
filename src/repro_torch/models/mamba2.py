"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060); port of
``repro/models/mamba2.py``.

Chunked SSD: within a chunk the recurrence is evaluated as a masked
matmul (the "dual" attention form); chunk-boundary states are carried by
a short loop over chunks.  All decays stay in log space and are <= 0, so
every exp() is bounded by 1; the intra-chunk decays are masked before
the exp, where the reference masks after it (whose gradient is NaN once
a masked entry overflows).

Decode carries (conv ring state, SSD state [B, H, P, N]) per layer:
O(1) in sequence length.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.scan import remat as _remat
from repro_torch.models.scan import scan_layers


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: operands of mixed precision (the bf16 dry run's
    weights against fp32 state) meet in their common dtype."""
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dtype) for o in ops))

Params = Dict[str, Any]


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def init_layers(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None, lead=()) -> Params:
    d_inner, n_heads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    # A init in [1, 16) (log-uniform), dt bias via inverse softplus of
    # ~0.001-0.1
    a = torch.exp(L.uniform(gen, lead + (n_heads,), 0.0, math.log(16.0),
                            device))
    dt = torch.exp(L.uniform(gen, lead + (n_heads,), math.log(1e-3),
                             math.log(1e-1), device))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "norm": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "in_proj": L.init_linear(gen, cfg.d_model, d_in_proj, False, dtype,
                                 device, lead=lead),
        "conv_w": L.normal(gen, lead + (cfg.ssm_conv, conv_dim), dtype,
                           device) * 0.2,
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(a),
        "d_skip": torch.ones(lead + (n_heads,), dtype=torch.float32,
                             device=device),
        "dt_bias": dt_bias,
        "gated_norm": L.init_rmsnorm(d_inner, dtype, device, lead),
        "out_proj": L.init_linear(gen, d_inner, cfg.d_model, False, dtype,
                                  device, lead=lead),
    }


def pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of ``s`` that is <= chunk (SSD needs chunk | S)."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B, S, C]; w: [K, C]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # window sum: sum_j w[j] * x[t - (K-1) + j]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + x.shape[1], :] * w[j]
    return out + b


def ssd_chunked(
    x: torch.Tensor,     # [B, S, H, P]
    dt: torch.Tensor,    # [B, S, H] (post-softplus)
    a: torch.Tensor,     # [H] (negative)
    b_in: torch.Tensor,  # [B, S, N]
    c_in: torch.Tensor,  # [B, S, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    chunk = pick_chunk(s, chunk)
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)

    da = dtc * a                                    # [b,nc,l,h], <= 0
    l_cum = torch.cumsum(da, dim=2)

    # intra-chunk ("attention" dual form)
    diff = l_cum[:, :, :, None, :] - l_cum[:, :, None, :, :]   # [b,nc,i,j,h]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # the mask goes in before the exp: above the diagonal ``diff`` is
    # positive and its exp can overflow, and the gradient of a masked inf
    # is NaN (the reference's ``where(tri, exp(diff), 0)`` trains to NaN
    # so; the forward is the same either way)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  -math.inf))
    cb = _einsum("bcin,bcjn->bcij", cc, bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]          # [b,nc,i,j,h]
    y_intra = _einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk-boundary states
    decay_to_end = torch.exp(l_cum[:, :, -1:, :] - l_cum)      # [b,nc,l,h]
    z = _einsum("bclh,bclhp,bcln->bchpn", decay_to_end * dtc, xc, bc)
    chunk_decay = torch.exp(l_cum[:, :, -1, :])                # [b,nc,h]

    def step(state, inp):
        z_c, cd_c = inp                                        # [b,h,p,n],[b,h]
        new = cd_c[..., None, None] * state + z_c
        return new, state                                      # state at chunk START

    s0 = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    final, s_starts = scan_layers(
        step, s0, (z.transpose(0, 1), chunk_decay.transpose(0, 1)))
    s_starts = s_starts.transpose(0, 1)                        # [b,nc,h,p,n]

    y_cross = _einsum("bcin,bchpn,bcih->bcihp", cc, s_starts,
                           torch.exp(l_cum))
    y = (y_intra + y_cross).reshape(bsz, s, h, p)
    return y.to(x.dtype), final


def block_forward(lp: Params, cfg: ArchConfig, x: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    d_inner, n_heads, conv_dim = _dims(cfg)
    bsz, s, _ = x.shape
    zxbcdt = L.linear(lp["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]
    xbc = F.silu(causal_conv(xbc, lp["conv_w"], lp["conv_b"]))
    xs = xbc[..., :d_inner]
    b_in = xbc[..., d_inner:d_inner + cfg.ssm_state]
    c_in = xbc[..., d_inner + cfg.ssm_state:]
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    xh = xs.reshape(bsz, s, n_heads, cfg.ssm_head_dim)
    y, _ = ssd_chunked(xh, dt, a, b_in, c_in, chunk)
    y = y + lp["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(bsz, s, d_inner)
    y = L.rms_norm(lp["gated_norm"], y * F.silu(z))
    return L.linear(lp["out_proj"], y)


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Params:
    return {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), dtype, device) * 0.02,
        "layers": init_layers(gen, cfg, dtype, device, (cfg.n_layers,)),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab, False, dtype,
                                 device),
    }


def forward_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   *, chunk: int = 128, remat: bool = False) -> torch.Tensor:
    x = params["embed"][tokens.long()]

    def body(carry, lp):
        h = block_forward(lp, cfg, L.rms_norm(lp["norm"], carry), chunk)
        from repro_torch.distributed import hints
        return hints.constrain(carry + h, "batch", "model", None), None

    if remat:
        body = _remat(body)
    x, _ = scan_layers(body, x, params["layers"])
    return L.rms_norm(params["final_norm"], x)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            *, chunk: int = 128, remat: bool = False) -> torch.Tensor:
    x = forward_hidden(params, cfg, tokens, chunk=chunk, remat=remat)
    return x @ params["lm_head"]["w"].T


# -- decode -------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssd": torch.zeros(
            (cfg.n_layers, batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor, cache):
    """tokens: [B, 1] -> (logits [B, 1, V], new cache)."""
    d_inner, n_heads, conv_dim = _dims(cfg)
    x = params["embed"][tokens.long()]                           # [B,1,d]

    def body(carry, scanned):
        lp, conv_st, ssd_st = scanned
        xx = carry
        u = L.rms_norm(lp["norm"], xx)[:, 0]                     # [B,d]
        zxbcdt = L.linear(lp["in_proj"], u)
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
        dt_raw = zxbcdt[..., d_inner + conv_dim:]
        # conv ring state: window = [conv_st, xbc]
        win = torch.cat([conv_st, xbc[:, None, :]], dim=1)      # [B,K,conv]
        conv_out = _einsum("bkc,kc->bc", win, lp["conv_w"]) + lp["conv_b"]
        xbc_t = F.silu(conv_out)
        new_conv = win[:, 1:, :]
        xs = xbc_t[..., :d_inner]
        b_in = xbc_t[..., d_inner:d_inner + cfg.ssm_state]
        c_in = xbc_t[..., d_inner + cfg.ssm_state:]
        dt = F.softplus(dt_raw.float() + lp["dt_bias"])          # [B,H]
        a = -torch.exp(lp["a_log"])
        xh = xs.reshape(-1, n_heads, cfg.ssm_head_dim).float()
        decay = torch.exp(dt * a)                                # [B,H]
        upd = _einsum("bh,bhp,bn->bhpn", dt, xh, b_in.float())
        new_ssd = decay[..., None, None] * ssd_st + upd
        y = _einsum("bhpn,bn->bhp", new_ssd, c_in.float())
        y = y + lp["d_skip"][None, :, None] * xh
        y = y.reshape(-1, d_inner).to(xx.dtype)
        y = L.rms_norm(lp["gated_norm"], y * F.silu(z))
        out = L.linear(lp["out_proj"], y)[:, None, :]
        return xx + out, (new_conv, new_ssd)

    x, (new_conv, new_ssd) = scan_layers(
        body, x, (params["layers"], cache["conv"], cache["ssd"]))
    x = L.rms_norm(params["final_norm"], x)
    logits = x @ params["lm_head"]["w"].T
    return logits, {"conv": new_conv, "ssd": new_ssd, "pos": cache["pos"] + 1}
