"""Unified model API over every architecture of the zoo; port of
``repro/models/api.py``.

    init_params(cfg, generator, dtype, device) -> params tree
    train_loss(params, cfg, batch, ...)        -> scalar CE loss
    init_cache(cfg, batch, s_cache, dtype, device) -> decode cache tree
    serve_step(params, cfg, inputs, cache)     -> (logits, new cache)
    prefill(params, cfg, inputs, q_chunk=...)  -> last-position logits
    params_from_numpy(tree, device)            -> the reference's params

Params keep the reference's tree layout (leaves stacked over layers with
a leading ``[L]`` axis, linear weights ``[out, in]``), so a reference
tree brought across as numpy (``params_from_numpy``) runs here leaf for
leaf.  ``init_params`` draws on the generator's device: pass a
``torch.Generator(device="cuda")`` to initialise a full-width model on
the card without a host round trip.

The paper's technique hooks in through ``cbtd_layout(cfg)``: CBTD
patterns for every prunable linear of the arch; ``input_specs(cfg,
cell)`` gives the dry run's stand-ins for a shape cell's inputs.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._device import (DeviceLike, require_full_fp32_matmul,
                                 resolve_device)
from repro_torch.models import encdec, mamba2, rglru, transformer
from repro_torch.models.config import ArchConfig, ShapeCell
from repro_torch.models.lstm_am import params_from_numpy  # noqa: F401
from repro_torch.models.transformer import chunked_ce_loss, head_weight

DEC_TRAIN_FRAC = 8  # enc-dec: decoder length = seq_len / 8 in train cells


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device: DeviceLike = None):
    """Seeded random parameters on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    require_full_fp32_matmul(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_params(generator, cfg, dtype, device)
    if cfg.family == "ssm":
        return mamba2.init_params(generator, cfg, dtype, device)
    if cfg.family == "hybrid":
        return rglru.init_params(generator, cfg, dtype, device)
    if cfg.family == "audio":
        return encdec.init_params(generator, cfg, dtype, device)
    raise ValueError(cfg.family)


def train_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, q_chunk: int = 0, remat: bool = False) -> torch.Tensor:
    """batch keys by family:
      dense/moe/ssm/hybrid: tokens, targets
      vlm:                  inputs_embeds, targets
      audio:                frames, dec_tokens, dec_targets
    """
    if cfg.family in ("dense", "moe"):
        x = transformer.forward_hidden(params, cfg, batch["tokens"],
                                       q_chunk=q_chunk, remat=remat)
        return chunked_ce_loss(x, head_weight(params, cfg), batch["targets"])
    if cfg.family == "vlm":
        x = transformer.forward_hidden(params, cfg, None,
                                       inputs_embeds=batch["inputs_embeds"],
                                       q_chunk=q_chunk, remat=remat)
        return chunked_ce_loss(x, head_weight(params, cfg), batch["targets"])
    if cfg.family == "ssm":
        x = mamba2.forward_hidden(params, cfg, batch["tokens"], remat=remat)
        return chunked_ce_loss(x, params["lm_head"]["w"], batch["targets"])
    if cfg.family == "hybrid":
        x = rglru.forward_hidden(params, cfg, batch["tokens"],
                                 q_chunk=q_chunk, remat=remat)
        return chunked_ce_loss(x, params["lm_head"]["w"], batch["targets"])
    if cfg.family == "audio":
        enc_out = encdec.encode(params, cfg, batch["frames"],
                                q_chunk=q_chunk, remat=remat)
        x = encdec.decode_train_hidden(params, cfg, batch["dec_tokens"],
                                       enc_out, q_chunk=q_chunk, remat=remat)
        return chunked_ce_loss(x, params["lm_head"]["w"], batch["dec_targets"])
    raise ValueError(cfg.family)


def init_cache(cfg: ArchConfig, batch: int, s_cache: int, dtype=torch.float32,
               device: DeviceLike = None):
    """The decode cache; for the audio family ``s_cache`` is the encoder
    length of the cross-KV."""
    device = resolve_device(device)
    require_full_fp32_matmul(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_cache(cfg, batch, s_cache, dtype, device)
    if cfg.family == "ssm":
        return mamba2.init_cache(cfg, batch, dtype, device)
    if cfg.family == "hybrid":
        return rglru.init_cache(cfg, batch, dtype, device)
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, s_cache, dtype, device)
    raise ValueError(cfg.family)


def serve_step(params, cfg: ArchConfig, inputs, cache):
    """One decode step.  ``inputs``: tokens [B,1] (or embeds [B,1,d] for vlm)."""
    if cfg.family in ("dense", "moe"):
        return transformer.decode_step(params, cfg, inputs, cache)
    if cfg.family == "vlm":
        return transformer.decode_step(params, cfg, None, cache,
                                       inputs_embeds=inputs)
    if cfg.family == "ssm":
        return mamba2.decode_step(params, cfg, inputs, cache)
    if cfg.family == "hybrid":
        return rglru.decode_step(params, cfg, inputs, cache)
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, inputs, cache)
    raise ValueError(cfg.family)


def prefill(params, cfg: ArchConfig, inputs, *, q_chunk: int = 0):
    """Full-sequence forward.  Returns the last-position logits [B, 1, V]
    (what a serving system samples from); for the enc-dec arch, the
    encoder forward and the cross-KV build."""
    def last_logits(x, head_w):
        return x[:, -1:, :] @ head_w.T

    if cfg.family in ("dense", "moe"):
        x = transformer.forward_hidden(params, cfg, inputs, q_chunk=q_chunk)
        return last_logits(x, head_weight(params, cfg))
    if cfg.family == "vlm":
        x = transformer.forward_hidden(params, cfg, None, inputs_embeds=inputs,
                                       q_chunk=q_chunk)
        return last_logits(x, head_weight(params, cfg))
    if cfg.family == "ssm":
        x = mamba2.forward_hidden(params, cfg, inputs)
        return last_logits(x, params["lm_head"]["w"])
    if cfg.family == "hybrid":
        x = rglru.forward_hidden(params, cfg, inputs, q_chunk=q_chunk)
        return last_logits(x, params["lm_head"]["w"])
    if cfg.family == "audio":
        enc_out = encdec.encode(params, cfg, inputs, q_chunk=q_chunk)
        return encdec.build_cross_cache(params, cfg, enc_out)
    raise ValueError(cfg.family)


def input_specs(cfg: ArchConfig, cell: ShapeCell,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``meta`` tensors (shape and dtype, no memory) standing in for every
    model input of a shape cell, the reference's ``ShapeDtypeStruct``s."""
    b, s = cell.global_batch, cell.seq_len

    def spec(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    if cell.kind == "train":
        if cfg.family == "vlm":
            return {"inputs_embeds": spec((b, s, cfg.d_model), dtype),
                    "targets": spec((b, s))}
        if cfg.family == "audio":
            s_dec = s // DEC_TRAIN_FRAC
            return {"frames": spec((b, s, cfg.d_model), dtype),
                    "dec_tokens": spec((b, s_dec)),
                    "dec_targets": spec((b, s_dec))}
        return {"tokens": spec((b, s)), "targets": spec((b, s))}
    if cell.kind == "prefill":
        if cfg.family in ("vlm", "audio"):
            return {"inputs": spec((b, s, cfg.d_model), dtype)}
        return {"inputs": spec((b, s))}
    if cell.kind == "decode":
        if cfg.family == "vlm":
            return {"inputs": spec((b, 1, cfg.d_model), dtype)}
        return {"inputs": spec((b, 1))}
    raise ValueError(cell.kind)


def make_train_batch(cfg: ArchConfig, generator: torch.Generator, batch: int,
                     seq: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A random batch of the family's inputs, drawn on the generator's
    device.  As in the reference, the audio batch's ``dec_targets`` equal
    its ``dec_tokens`` (both are drawn from one key there)."""
    dev = generator.device
    if cfg.family == "vlm":
        return {
            "inputs_embeds": torch.randn((batch, seq, cfg.d_model),
                                         generator=generator, dtype=dtype,
                                         device=dev),
            "targets": torch.randint(0, cfg.vocab, (batch, seq),
                                     generator=generator, device=dev),
        }
    if cfg.family == "audio":
        s_dec = max(seq // DEC_TRAIN_FRAC, 4)
        dec = torch.randint(0, cfg.vocab, (batch, s_dec), generator=generator,
                            device=dev)
        return {
            "frames": torch.randn((batch, seq, cfg.d_model),
                                  generator=generator, dtype=dtype,
                                  device=dev),
            "dec_tokens": dec,
            "dec_targets": dec.clone(),
        }
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=generator,
                         device=dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def cbtd_layout(cfg: ArchConfig, gamma: float = 0.94, m: int = 64):
    """CBTD patterns covering every prunable linear of the arch (embeddings,
    norms and the logit/lm head excluded, per the paper's practice)."""
    from repro_torch.core.cbtd import CBTDConfig

    c = CBTDConfig(gamma=gamma, m=m)
    pats = {}
    if cfg.family in ("dense", "moe", "vlm"):
        pats.update({"attn/q/w": c, "attn/k/w": c, "attn/v/w": c, "attn/o/w": c})
        if cfg.family == "moe":
            pats.update({"moe/gate": c, "moe/up": c, "moe/down": c})
        else:
            pats.update({"mlp/gate/w": c, "mlp/up/w": c, "mlp/down/w": c})
    elif cfg.family == "ssm":
        pats.update({"in_proj/w": c, "out_proj/w": c})
    elif cfg.family == "hybrid":
        pats.update({
            "attn/q/w": c, "attn/k/w": c, "attn/v/w": c, "attn/o/w": c,
            "rglru/in_x/w": c, "rglru/in_y/w": c, "rglru/out/w": c,
            "rglru/gate_a/w": c, "rglru/gate_i/w": c,
            "mlp/gate/w": c, "mlp/up/w": c, "mlp/down/w": c,
        })
    elif cfg.family == "audio":
        pats.update({
            "attn/q/w": c, "attn/k/w": c, "attn/v/w": c, "attn/o/w": c,
            "self_attn/q/w": c, "self_attn/k/w": c, "self_attn/v/w": c,
            "self_attn/o/w": c, "cross_attn/q/w": c, "cross_attn/k/w": c,
            "cross_attn/v/w": c, "cross_attn/o/w": c,
            "mlp/gate/w": c, "mlp/up/w": c, "mlp/down/w": c,
        })
    return pats
