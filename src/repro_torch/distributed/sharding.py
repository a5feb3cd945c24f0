"""Partition rules: DP x FSDP x TP (x pod) partition specs for every arch;
port of ``repro/distributed/sharding.py``.

Strategy (the reference's):
  * batch dims shard over ("pod","data") when divisible;
  * TP: attention heads / ffn / experts / vocab shard over "model";
  * FSDP: the non-TP dim of every large matrix shards over "data";
  * any dim not divisible by its axis size falls back to replication —
    rules never produce invalid shardings (this is what makes one rule
    table serve 10 architectures).

Rules are name-substring keyed, most-specific-first; each is checked
against the actual leaf shape.  A spec is a ``PartitionSpec``: a tuple
with one entry per dimension, an axis name, a tuple of names, or None,
as ``jax.sharding.PartitionSpec`` reads.  Leaf names are the ``"/"``-
joined tree paths of ``repro_torch._tree``; an ``AdamState`` field is
named by its index (``1/layers/...``) where the reference writes
``.m/layers/...``, and no rule is anchored at the start of a name, so
the specs agree.

Placing a tree (``NamedSharding.place``, ``device_put``) puts every leaf
whole on the one device of a one-device mesh.  On a mesh of several
devices a leaf becomes a `ShardedTensor`: one tensor per mesh device, in
the mesh's row-major order, each the block its ``PartitionSpec`` gives
that device (a dimension sharded over an axis group splits into equal
blocks; along a replicated one every device holds the whole extent).
There is no GSPMD: the port is single-controller, one process holds
every shard, and `gather` (the inverse) reassembles a leaf on any one
device or the host.  The devices of a mesh may repeat
(``launch.mesh.emulated_devices``): every block is a tensor of its own
all the same, so the bytes placed on a logical device are its blocks'.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.launch.mesh import Mesh, axis_size, data_axes
from repro_torch.models.config import ArchConfig


class PartitionSpec(tuple):
    """Per-dimension mesh axes (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (a name, a tuple of names, None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A leaf laid out on a mesh of several devices: ``shards[i]`` is the
    block of mesh device ``i`` (row-major), a tensor of its own on that
    device.  A tree leaf (``_tree`` descends only into dicts, lists and
    tuples)."""
    shards: Tuple[torch.Tensor, ...]
    shape: torch.Size
    spec: PartitionSpec
    mesh: Mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)


def _blocks(spec: PartitionSpec, mesh: Mesh, ndim: int
            ) -> List[Tuple[Tuple[int, int], ...]]:
    """Per mesh device (row-major), per dimension: (block index, block
    count) under ``spec``; an axis group's index is row-major over the
    group's axes in the order the spec names them."""
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for coord in np.ndindex(*mesh.axis_sizes):
        at = dict(zip(mesh.axis_names, coord))
        dims = []
        for entry in entries:
            idx, count = 0, 1
            for ax in _axes(entry):
                size = mesh.shape[ax]
                idx, count = idx * size + at[ax], count * size
            dims.append((idx, count))
        out.append(tuple(dims))
    return out


def _block(x: torch.Tensor, dims) -> torch.Tensor:
    for d, (idx, count) in enumerate(dims):
        if count > 1:
            x = x.tensor_split(count, dim=d)[idx]
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def place(self, x):
        """``x`` (a tensor, a numpy array or a `ShardedTensor` of another
        layout) laid out by this sharding: whole on the mesh's device when
        the mesh has one, else a `ShardedTensor` whose every block is a
        copy of its own.  A shape-only mesh holds nothing and raises."""
        if not self.mesh.devices:
            raise ValueError(f"mesh {self.mesh.shape} is shape-only: "
                             f"nothing can be placed on it")
        first = self.mesh.devices[0]
        if isinstance(x, ShardedTensor):
            x = gather(x, first)
        elif isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if self.mesh.size == 1:
            return x.to(first)
        shape = x.shape
        for d, entry in enumerate(self.spec):
            count = math.prod(self.mesh.shape[a] for a in _axes(entry))
            if shape[d] % count:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {count} blocks ({self.spec})")
        shards = tuple(
            torch.empty(b.shape, dtype=b.dtype, device=dev).copy_(b)
            for b, dev in zip((_block(x, dims) for dims in
                               _blocks(self.spec, self.mesh, x.ndim)),
                              self.mesh.devices))
        return ShardedTensor(shards, shape, self.spec, self.mesh)


def gather(x, device=None) -> torch.Tensor:
    """The whole tensor of a `ShardedTensor` on ``device`` (the host by
    default), each block copied from the first mesh device holding it; a
    plain tensor is moved there."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if not isinstance(x, ShardedTensor):
        return x.to(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    seen = set()
    for dims, shard in zip(_blocks(x.spec, x.mesh, x.ndim), x.shards):
        if dims in seen:
            continue
        seen.add(dims)
        _block(out, dims).copy_(shard)
    return out


def host_tree(tree):
    """``tree`` with every tensor on the host, each `ShardedTensor`
    gathered (a checkpoint's or ``elastic.reshard``'s input); a tensor
    already there is itself."""
    return _tree.tree_map(
        lambda x: gather(x) if isinstance(x, (torch.Tensor, ShardedTensor))
        else x, tree)


def placed_bytes(tree) -> List[int]:
    """The bytes of ``tree`` on each device of its mesh (row-major): each
    `ShardedTensor`'s blocks, a plain tensor's whole on its one device."""
    per = None
    for leaf in _tree.leaves(tree):
        parts = (leaf.shards if isinstance(leaf, ShardedTensor) else (leaf,))
        sizes = [p.numel() * p.element_size() for p in parts]
        per = sizes if per is None else [a + b for a, b in zip(per, sizes)]
    return per or []


def _div(dim: int, mesh: Mesh, *axes: str):
    """Return the axis group if it divides dim, else None (replicate)."""
    if not axes:
        return None
    size = axis_size(mesh, *axes)
    if size > 1 and dim % size == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def _spec_matmul(shape, mesh: Mesh, tp_dim: int, fsdp_dim: int,
                 fsdp: bool = True, tp: bool = True) -> PartitionSpec:
    """Spec for a (possibly layer/expert-stacked) matrix: put "model" on
    ``tp_dim`` (negative index from the end), "data" on ``fsdp_dim``."""
    nd = len(shape)
    spec = [None] * nd
    if tp:
        ax = _div(shape[nd + tp_dim], mesh, "model")
        if ax:
            spec[nd + tp_dim] = ax
    if fsdp:
        fs = _div(shape[nd + fsdp_dim], mesh, "data")
        if fs:
            spec[nd + fsdp_dim] = fs
    return P(*spec)


# name-pattern -> (tp_dim, fsdp_dim) on the trailing two axes of the leaf.
# weights are [out, in]:  column-parallel => tp on -2, row-parallel => tp on -1.
_MATRIX_RULES = [
    # attention: q/k/v column-parallel (heads), o row-parallel
    (r"attn/(q|k|v)/w$", (-2, -1)),
    (r"attn/o/w$", (-1, -2)),
    (r"(self|cross)_attn/(q|k|v)/w$", (-2, -1)),
    (r"(self|cross)_attn/o/w$", (-1, -2)),
    # MLP: gate/up column-parallel (ffn), down row-parallel
    (r"mlp/(gate|up)/w$", (-2, -1)),
    (r"mlp/down/w$", (-1, -2)),
    # lstm AM
    (r"w_x$", (-2, -1)),
    (r"w_h$", (-2, -1)),
    (r"fcl/w$", (-2, -1)),
    # rglru block
    (r"rglru/(in_x|in_y)/w$", (-2, -1)),
    (r"rglru/(gate_a|gate_i)/w$", (-2, -1)),
    (r"rglru/out/w$", (-1, -2)),
    # mamba2
    (r"in_proj/w$", (-2, -1)),
    (r"out_proj/w$", (-1, -2)),
    # heads / embeddings: vocab-parallel
    (r"lm_head/w$", (-2, -1)),
    (r"logit/w$", (-2, -1)),
]

# MoE experts: [.., E, ff, d] / [.., E, d, ff] — expert-parallel over model,
# FSDP over the trailing input dim.
_MOE_RULES = [
    (r"moe/(gate|up)$", ("model", None, "data")),
    (r"moe/down$", ("model", None, "data")),
    (r"moe/router/w$", None),
]


def _heads_shardable(name: str, cfg: Optional[ArchConfig], mesh: Mesh) -> bool:
    """Attention projections may TP-shard only if the *head count* divides
    the model-axis size, so the [B,S,H,hd] activation view stays
    head-aligned."""
    if cfg is None:
        return True
    tp = axis_size(mesh, "model")
    if tp <= 1:
        return True
    if re.search(r"attn/(q|o)/", name):
        return cfg.n_heads % tp == 0
    if re.search(r"attn/(k|v)/", name):
        return cfg.n_kv_heads % tp == 0
    return True


def param_spec(name: str, shape: Tuple[int, ...], mesh: Mesh,
               cfg: Optional[ArchConfig] = None) -> PartitionSpec:
    from repro_torch.perf import current

    if len(shape) < 2:
        return P(*([None] * len(shape)))

    if current().fsdp_sp:
        # perf variant: no TP — weights shard over BOTH axes (2-D FSDP)
        nd = len(shape)
        spec = [None] * nd
        if _div(shape[-1], mesh, "data"):
            spec[-1] = "data"
        if _div(shape[-2], mesh, "model"):
            spec[-2] = "model"
        return P(*spec)
    for pat, dims in _MOE_RULES:
        if re.search(pat, name):
            if dims is None:
                return P()
            nd = len(shape)
            spec = [None] * nd
            e_ax = nd - 3
            if _div(shape[e_ax], mesh, "model"):
                spec[e_ax] = "model"
            if dims[2] and _div(shape[nd - 1], mesh, "data"):
                spec[nd - 1] = "data"
            return P(*spec)
    for pat, (tp_dim, fsdp_dim) in _MATRIX_RULES:
        if re.search(pat, name):
            if "attn/" in pat and not _heads_shardable(name, cfg, mesh):
                # FSDP-only fallback: shard the input dim over "data"
                return _spec_matmul(shape, mesh, tp_dim, fsdp_dim,
                                    fsdp=True, tp=False)
            return _spec_matmul(shape, mesh, tp_dim, fsdp_dim)
    if re.search(r"embed$", name):
        # vocab gather stays local; FSDP over the feature dim only
        nd = len(shape)
        spec = [None] * nd
        if _div(shape[-1], mesh, "data"):
            spec[-1] = "data"
        return P(*spec)
    # rglru per-channel params [.., W]
    if re.search(r"(lambda_raw|conv_w|conv_b)$", name) and shape:
        spec = [None] * len(shape)
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
        return P(*spec)
    return P()  # norms, biases, scalars: replicate


def param_specs(params, mesh: Mesh, cfg: Optional[ArchConfig] = None):
    """Spec tree for a parameter (or AdamW state) tree."""
    return _tree.map_with_path(
        lambda name, leaf: param_spec(name, tuple(leaf.shape), mesh, cfg),
        params)


# -- batch / cache ------------------------------------------------------------


def batch_spec(shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    """Shard dim0 (global batch) over (pod, data) when divisible."""
    return slot_spec(shape, mesh, dim=0)


def slot_spec(shape: Tuple[int, ...], mesh: Mesh, dim: int = 0
              ) -> PartitionSpec:
    """Slot/batch-dimension data parallelism: shard ``dim`` over the
    (pod, data) axes when divisible, else replicate."""
    dp = data_axes(mesh)
    ax = _div(shape[dim], mesh, *dp)
    spec = [None] * len(shape)
    if ax:
        spec[dim] = ax
    return P(*spec)


def batch_specs(batch_tree, mesh: Mesh):
    return _tree.tree_map(lambda l: batch_spec(tuple(l.shape), mesh),
                          batch_tree)


def cache_spec(name: str, shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    """KV/state caches: [L, B, ...] — batch over (pod,data) on dim1, heads
    over model where divisible.  Scalars (pos) replicate."""
    if len(shape) == 0:
        return P()
    dp = data_axes(mesh)
    spec = [None] * len(shape)
    if len(shape) >= 2:
        ax = _div(shape[1], mesh, *dp)
        if ax:
            spec[1] = ax
    # kv caches [L, B, S, H, hd]: try heads; ssd [L,B,H,P,N]: try heads;
    # rglru h [n,B,W] / conv [n,B,K,W]: try trailing width.
    if re.search(r"/(k|v)$", name) and len(shape) == 5:
        if _div(shape[3], mesh, "model"):
            spec[3] = "model"
        elif _div(shape[2], mesh, "model"):
            # too few kv heads for the model axis: shard the cache
            # SEQUENCE dim instead
            spec[2] = "model"
    elif re.search(r"ssd$", name) and len(shape) == 5:
        if _div(shape[2], mesh, "model"):
            spec[2] = "model"
    elif len(shape) >= 3 and re.search(r"(h|conv)$", name):
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
    return P(*spec)


def cache_specs(cache_tree, mesh: Mesh):
    return _tree.map_with_path(
        lambda name, leaf: cache_spec(name, tuple(getattr(leaf, "shape", ())),
                                      mesh),
        cache_tree)


def to_shardings(spec_tree, mesh: Mesh):
    return _tree.tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                          is_leaf=is_spec)


def device_put(tree, shardings):
    """``tree`` with every leaf placed by the matching ``NamedSharding``."""
    return _tree.tree_map(lambda x, s: s.place(x), tree, shardings)
