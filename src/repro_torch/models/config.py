"""Architecture configuration for the model zoo; port of
``repro/models/config.py`` (plain Python, copied: the port imports
nothing of the JAX package).

One ``ArchConfig`` instance per architecture lives in
``repro_torch/configs/``; ``reduced()`` derives the small variant of the
same family that the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    # flags
    qkv_bias: bool = False               # qwen2
    qk_norm: bool = False                # qwen3
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid (recurrentgemma): layer pattern unit, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ()
    attn_window: int = 0                 # sliding-window size (0 = global)
    lru_width: int = 0
    # enc-dec (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stub: inputs are precomputed embeddings of this dim
    embed_inputs: bool = False
    # paper technique applicability (DESIGN.md §4)
    delta_applicable: bool = False
    # long_500k support (sub-quadratic sequence mixing)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ArchConfig":
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0, self.name
        if self.family == "ssm":
            assert self.ssm_state > 0, self.name
        if self.family == "hybrid":
            assert self.block_pattern, self.name
        if self.family == "audio":
            assert self.n_enc_layers and self.n_dec_layers, self.name
        return self

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests: small widths, few
        layers/experts, small vocab — structure preserved."""
        def shrink_pattern(p):
            return p[: min(len(p), 3)] if p else p

        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 * max(len(self.block_pattern), 1)),
            d_model=128 if self.hd <= 128 else 256,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            head_dim=64 if (self.head_dim or 0) else None,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            lru_width=128 if self.lru_width else 0,
            attn_window=min(self.attn_window, 16) if self.attn_window else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            block_pattern=self.block_pattern,
        )


# ---------------------------------------------------------------------------
# Input-shape cells (assigned): every LM arch gets all four; decode shapes
# lower serve_step; long_500k only for sub-quadratic archs.

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped). Per assignment: long_500k needs
    sub-quadratic attention; pure full-attention archs skip it."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(S^2) at 524k out of scope (assignment rule)"
    return True, ""
