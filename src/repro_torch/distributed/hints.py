"""Sharding annotations inside model code; port of
``repro/distributed/hints.py``.

Model code calls ``constrain(x, "batch", "model", None, ...)`` at
layout-critical points (attention, MoE dispatch buffers, the residual
stream, vocab-parallel logits).  The spec resolves exactly as the
reference's: unknown axis names are dropped (single-pod meshes have no
"pod"), "batch" is the virtual axis ("pod", "data"), and a dimension its
axis size does not divide falls back to replication, so an annotation is
always valid.

Outside a mesh context (``launch.mesh.mesh_context``) ``constrain`` is
the identity.  Inside one it is the identity on values too: the port's
sharded step computes each data replica on whole tensors on one device
(``launch/steps.py``), so there is no partitioner to steer.  The
resolved specs are kept where a caller asks for them (``recorded``): the
tests hold them to the reference's, and an analysis pass may read them.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch import mesh as _mesh

_RECORD: Optional[List[Tuple[Tuple[int, ...], P]]] = None


def _current_axes():
    """The active mesh, or None outside a mesh context."""
    mesh = _mesh.active_mesh()
    if mesh is None or not mesh.axis_names:
        return None
    return mesh


@contextlib.contextmanager
def recorded():
    """Within the block, every ``constrain`` inside a mesh context appends
    ``(shape, resolved spec)`` to the list this yields."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def shard_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Layout for an attention block with expanded heads [B, S, H, hd].

    If the head count divides the model axis: tensor-parallel heads (q,
    k, v all head-sharded).  Otherwise sequence-parallel queries (q rows
    sharded over "model", k/v replicated): every device computes its own
    query rows against the full KV, which partitions the O(S^2) score
    memory and the flops even for awkward head counts (qwen2's 14 heads).
    Under the ``fsdp_sp`` perf variant sequence parallelism is forced for
    every arch."""
    from repro_torch.perf import current

    mesh = _current_axes()
    if mesh is None or "model" not in mesh.axis_names:
        return q, k, v
    tp = mesh.shape["model"]
    h = q.shape[2]
    force_sp = current().fsdp_sp
    if tp > 1 and h % tp == 0 and not force_sp:
        q = constrain(q, "batch", None, "model", None)
        k = constrain(k, "batch", None, "model", None)
        v = constrain(v, "batch", None, "model", None)
    elif tp > 1 and q.shape[1] % tp == 0:
        q = constrain(q, "batch", "model", None, None)
    return q, k, v


def shard_attn_decode(q: torch.Tensor, ke: torch.Tensor, ve: torch.Tensor,
                      n_kv_heads: int):
    """Decode-step layout that follows the KV cache's own sharding:
    head-shardable caches -> head TP (q too); otherwise the cache is
    sequence-sharded (``sharding.cache_spec``) and, with
    ``seq_sharded_decode``, the expanded K/V stay sequence-sharded (a
    distributed flash-decode) instead of being gathered every token."""
    from repro_torch.perf import current

    mesh = _current_axes()
    if mesh is None or "model" not in mesh.axis_names:
        return q, ke, ve
    tp = mesh.shape["model"]
    h = q.shape[2]
    s = ke.shape[1]
    if tp > 1 and n_kv_heads % tp == 0 and h % tp == 0:
        q = constrain(q, "batch", None, "model", None)
        ke = constrain(ke, "batch", None, "model", None)
        ve = constrain(ve, "batch", None, "model", None)
    elif tp > 1 and s % tp == 0 and current().seq_sharded_decode:
        ke = constrain(ke, "batch", "model", None, None)
        ve = constrain(ve, "batch", "model", None, None)
    return q, ke, ve


def resolve(shape: Tuple[int, ...], axes, mesh) -> P:
    """The spec ``constrain(x, *axes)`` gives a tensor of ``shape`` on
    ``mesh`` (the reference's resolution)."""
    names = set(mesh.axis_names)
    spec = []
    for dim, ax in enumerate(axes):
        if ax == "batch":
            group = tuple(a for a in ("pod", "data") if a in names)
            size = 1
            for a in group:
                size *= mesh.shape[a]
            if group and size > 1 and shape[dim] % size == 0:
                spec.append(group if len(group) > 1 else group[0])
            else:
                spec.append(None)
        elif (ax in names and mesh.shape[ax] > 1
              and shape[dim] % mesh.shape[ax] == 0):
            spec.append(ax)
        else:
            spec.append(None)
    return P(*spec)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` itself; inside a mesh context its resolved spec is recorded
    where ``recorded`` is active."""
    mesh = _current_axes()
    if mesh is not None and _RECORD is not None:
        _RECORD.append((tuple(x.shape), resolve(tuple(x.shape), axes, mesh)))
    return x
