"""Fixed-point quantization (Sec. IV-E / V-B) — port of
``repro/core/quantization.py``.

INT8 weights with a per-tensor power-of-two scale, Q8.8 activations.
Everything is computed in float32 like the reference; ``torch.round``
rounds half to even exactly like ``jnp.round``, which the Q8.8 ``.5``
points depend on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import _tree


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    weight_bits: int = 8
    act_bits: int = 16
    # fractional bits for activations (Q8.8 by default, like EdgeDRNN/Spartus)
    act_frac_bits: int = 8
    enabled: bool = True


def pow2_scale_for(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Smallest power-of-two scale covering max|w| in a signed ``bits``
    grid (float32 0-d tensor): ``2^ceil(log2(amax / qmax))``."""
    amax = torch.clamp(w.abs().max().to(torch.float32), min=1e-8)
    qmax = 2.0 ** (bits - 1) - 1
    return torch.exp2(torch.ceil(torch.log2(amax / qmax)))


def quantize(w: torch.Tensor, bits: int,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform symmetric fake-quant to ``bits`` (codes in [-qmax, qmax])."""
    if scale is None:
        scale = pow2_scale_for(w, bits)
    qmax = 2.0 ** (bits - 1) - 1
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def fake_quant_ste(w: torch.Tensor, bits: int,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dual-copy rounding: forward = quantized, backward = identity."""
    return w + (quantize(w, bits, scale) - w).detach()


def quantize_act(x: torch.Tensor, bits: int = 16,
                 frac_bits: int = 8) -> torch.Tensor:
    """Fixed-point Qm.n activation quantization (scale 2^-n), saturating at
    the full two's-complement range [-2^(bits-1), 2^(bits-1) - 1]."""
    scale = 2.0 ** (-frac_bits)
    qmax = 2.0 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale


def fake_quant_act_ste(x: torch.Tensor, bits: int = 16,
                       frac_bits: int = 8) -> torch.Tensor:
    return x + (quantize_act(x, bits, frac_bits) - x).detach()


def int8_pack(w: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """int8 storage on the symmetric [-127, 127] grid -> (q int8, scale)."""
    if scale is None:
        scale = pow2_scale_for(w, 8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale



def quantize_tree(params, bits: int = 8):
    """Quantize every floating-point leaf of ndim >= 1 (deployment-time,
    no STE)."""
    def q(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.ndim >= 1):
            return quantize(leaf, bits)
        return leaf
    return _tree.tree_map(q, params)


def int8_unpack(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale
