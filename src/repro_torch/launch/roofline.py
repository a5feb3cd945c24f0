"""Roofline terms of a dry-run step on the H100; port of
``repro/launch/roofline.py``.

Hardware constants: NVIDIA's H100 SXM5 80 GB data sheet (dense rates,
no sparsity, at the full 700 W power limit).  They are the data sheet's
figures, not measurements:
    989 TFLOP/s bf16 | 67 TFLOP/s fp32 (no tensor cores) |
    3.35 TB/s HBM3 | 900 GB/s NVLink (aggregate, one card)

Terms (per device):
    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM rate
    collective = collective bytes / NVLink rate

``collective_bytes`` parses collectives out of XLA HLO text, as the
reference does: per instruction the result-shape bytes times a
ring-model factor for a replica group of size n:
    all-gather        r * (n-1)/n       (r = full gathered result)
    reduce-scatter    r * (n-1)         (r = the shard each device keeps)
    all-reduce        2r * (n-1)/n      (RS + AG)
    all-to-all        r * (n-1)/n
    collective-permute r
The port compiles no HLO: its dry run (``launch/dryrun.py``) prices its
own traffic from the partition specs with the same factors, and hands
`analyze` a `StepCost` in place of an XLA executable.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM5 data sheet
PEAK_FLOPS_FP32 = 67e12    # fp32 without tensor cores, same sheet
HBM_BW = 3.35e12           # bytes/s, HBM3, same sheet
NVLINK_BW = 900e9          # bytes/s, NVLink aggregate per card, same sheet

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\][^ ]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(",
)
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # replica_groups=[G,n]<=[N]: G groups of size n
        return int(m.group(2))
    return default


def ring_bytes(kind: str, r: float, n: int) -> float:
    """Per-device bytes of one collective of kind ``kind`` over a group
    of ``n`` (the ring model above); 0 for a group of one."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return r * (n - 1) / n
    if kind == "reduce-scatter":
        return r * (n - 1)
    if kind == "all-reduce":
        return 2 * r * (n - 1) / n
    if kind == "all-to-all":
        return r * (n - 1) / n
    return r  # collective-permute


def collective_bytes(hlo_text: str,
                     n_devices: int) -> Tuple[float, Dict[str, float]]:
    """Per-device collective bytes of HLO text, total and by kind."""
    per_kind: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shapes = m.group(1) or m.group(2)
        kind = m.group(3)
        n = max(_group_size(line, n_devices), 1)
        if n == 1:
            continue
        per_kind[kind] = per_kind.get(kind, 0.0) + ring_bytes(
            kind, _shape_bytes(shapes), n)
    return sum(per_kind.values()), per_kind


@dataclasses.dataclass
class StepCost:
    """What the port's dry run counts for one device's step: operations,
    the bytes its ops read and write, and collective bytes by kind."""
    flops: float
    hbm_bytes: float
    coll_breakdown: Dict[str, float]


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device flops
    hbm_bytes: float           # per-device bytes accessed
    coll_bytes: float          # per-device collective bytes
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float   # 6ND-style useful flops (whole job)
    useful_ratio: float        # model_flops / (flops * devices)
    n_devices: int

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: StepCost, n_devices: int,
            model_flops_total: float) -> Roofline:
    """The roofline terms of one device's step cost."""
    coll = sum(cost.coll_breakdown.values())
    terms = {"compute": cost.flops / PEAK_FLOPS,
             "memory": cost.hbm_bytes / HBM_BW,
             "collective": coll / NVLINK_BW}
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, coll_bytes=coll,
        coll_breakdown=dict(cost.coll_breakdown),
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops_total=model_flops_total,
        useful_ratio=model_flops_total / max(cost.flops * n_devices, 1.0),
        n_devices=n_devices,
    )


def model_flops(cfg, cell, n_params_nonembed: int) -> float:
    """6ND for training, 2ND for single forward (prefill; the vocab head
    runs on the last position only), 2N*B per decoded token.  MoE uses
    active params (top_k/n_experts of expert weights)."""
    n = n_params_nonembed
    head = 0 if cfg.family == "audio" else cfg.vocab * cfg.d_model
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        if cfg.family == "audio":
            tokens = cell.global_batch * (cell.seq_len + cell.seq_len // 8)
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        body = 2.0 * (n - head) * cell.global_batch * cell.seq_len
        return body + 2.0 * head * cell.global_batch
    # decode: one token per sequence
    return 2.0 * n * cell.global_batch


def active_params(cfg, params_abs) -> int:
    """Matmul-active parameter count: excludes untied embeddings; scales
    expert weights by top_k/n_experts; counts the lm_head."""
    from repro_torch import _tree

    total = 0
    for name, leaf in _tree.leaves_with_path(params_abs):
        size = leaf.numel()
        if name.endswith("embed") and not cfg.tie_embeddings:
            continue
        if "moe/" in name and ("gate" in name or "up" in name
                               or "down" in name):
            size = size * cfg.top_k // max(cfg.n_experts, 1)
        total += size
    return total
