"""Slot-dimension data parallelism for the serving pool — port of
``repro/serving/sharding.py``.

The pool's *slot* dimension is partitioned over the devices of a 1-D
``("data",)`` mesh: every per-slot slab the pool owns (layer state, delta
memories, cursors, telemetry, frame buffers, lengths, the logits bank)
is split into contiguous blocks of slots, one per shard, each on its
shard's device.  Slots are independent, so each shard's chunk is the
unsharded chunk at the shard's batch, dispatched on its own device with
no cross-shard traffic.  Only admission (the staged upload) and
retirement (the host fetch) touch a shard's rows from the host.

Where the reference places one array with a ``NamedSharding`` and lets
GSPMD partition the program, the port splits a `PoolState` into one
`PoolState` per shard (`shard_pool_state`) and joins host copies back
(`join_pool_state`): layer slabs and the cursor at dim 0, the ``[L, B]``
telemetry at dim 1, as `pool_state_shardings` lays them out.

Placement follows `distributed/sharding.py`'s never-invalid rule
(`slot_spec`): a capacity the shard count does not divide gets one
shard, on the mesh's first device.  That is the counterpart of the
reference's replication: the same results, not parallel.

The devices of a mesh may repeat: ``launch.mesh.emulated_devices(n)``
gives ``n`` logical shards on one device, the counterpart of the
reference's ``--xla_force_host_platform_device_count``.  Nothing here
assumes two shards' devices differ.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import NamedSharding, slot_spec
from repro_torch.launch.mesh import Mesh, axis_size, data_axes, make_data_mesh
from repro_torch.serving.batched_engine import BatchedLayerState, PoolState
from repro_torch.serving.telemetry import TelemetryState


def make_pool_mesh(n_devices: Optional[int],
                   device: DeviceLike = None) -> Mesh:
    """1-D ``("data",)`` mesh over ``n_devices`` devices of ``device``'s
    type; raises when fewer are visible.  ``None``: the one-device mesh
    over ``device`` itself (the unsharded pool)."""
    if n_devices is None:
        return Mesh(("data",), (1,), (resolve_device(device),))
    return make_data_mesh(int(n_devices), device)


def mesh_data_size(mesh: Mesh) -> int:
    """Number of shards the mesh's data axes provide."""
    return axis_size(mesh, *data_axes(mesh))


def n_pool_shards(mesh: Mesh, capacity: int) -> int:
    """Effective shard count for a ``capacity``-slot pool on ``mesh``:
    the data-axis size when it divides capacity, else 1 (`slot_spec`'s
    never-invalid fallback)."""
    size = mesh_data_size(mesh)
    return size if size > 1 and capacity % size == 0 else 1


def shard_bounds(capacity: int, n_shards: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` slot ranges owned by each shard (contiguous, equal
    blocks)."""
    per = capacity // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


def shard_devices(mesh: Mesh, capacity: int) -> List[torch.device]:
    """The device of each shard of a ``capacity``-slot pool on ``mesh``
    (the mesh's first device alone in the fallback)."""
    return list(mesh.devices[:n_pool_shards(mesh, capacity)])


def slot_sharding(shape, mesh: Mesh, dim: int = 0) -> NamedSharding:
    """The sharding of one per-slot slab (``dim`` = the slot axis)."""
    return NamedSharding(mesh, slot_spec(tuple(shape), mesh, dim=dim))


def _split(x: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """``x`` cut along its sharded dim into one contiguous tensor per
    shard, each on its shard's device (whole on the first device when
    the spec replicates: ``x`` itself if it is already there)."""
    dims = [d for d, ax in enumerate(sharding.spec) if ax is not None]
    if not dims:
        dev = sharding.mesh.devices[0]
        if x.device == dev and x.is_contiguous():
            return [x]
        parts, devices = [x], [dev]
    else:
        devices = sharding.mesh.devices[:mesh_data_size(sharding.mesh)]
        parts = x.tensor_split(len(devices), dim=dims[0])
    return [torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(p)
            for p, dev in zip(parts, devices)]


def shard_slot_array(x: torch.Tensor, mesh: Mesh,
                     dim: int = 0) -> List[torch.Tensor]:
    """One per-slot slab split into its shards' blocks, each a tensor of
    its own on its shard's device."""
    return _split(x, slot_sharding(x.shape, mesh, dim=dim))


def _map_state(fn: Callable, state: PoolState, *rest: PoolState) -> PoolState:
    """``fn`` applied leaf by leaf over one or more PoolStates."""
    return PoolState(
        layers=tuple(BatchedLayerState(*map(fn, *ls))
                     for ls in zip(state.layers, *(r.layers for r in rest))),
        telemetry=TelemetryState(*map(fn, state.telemetry,
                                      *(r.telemetry for r in rest))),
        cursor=fn(state.cursor, *(r.cursor for r in rest)),
    )


def pool_state_shardings(state: PoolState, mesh: Mesh) -> PoolState:
    """The sharding of every `PoolState` slab: layer slabs and the cursor
    shard the slot axis at dim 0; the ``[L, B]`` telemetry accumulators
    at dim 1."""
    dim0 = lambda leaf: slot_sharding(leaf.shape, mesh, dim=0)  # noqa: E731
    dim1 = lambda leaf: slot_sharding(leaf.shape, mesh, dim=1)  # noqa: E731
    return PoolState(
        layers=tuple(BatchedLayerState(*map(dim0, l)) for l in state.layers),
        telemetry=TelemetryState(*map(dim1, state.telemetry)),
        cursor=dim0(state.cursor),
    )


def shard_pool_state(state: PoolState, mesh: Mesh) -> List[PoolState]:
    """One `PoolState` per shard, its slabs on the shard's device (copies
    when there are several shards: no shard shares storage with another
    or with ``state``; one shard on ``state``'s device is ``state``)."""
    split = _map_state(_split, state, pool_state_shardings(state, mesh))
    n = len(split.cursor)
    return [_map_state(lambda parts: parts[s], split) for s in range(n)]


def dispatch_chunk(state: Sequence[PoolState],
                   frames: Sequence[torch.Tensor],
                   lengths: Sequence[torch.Tensor], active: Sequence[Any],
                   reset: Sequence[Any], out_buf: Sequence[torch.Tensor], *,
                   engines: Sequence[Any], n_frames: int,
                   on_shard: Optional[Callable[[int], None]] = None
                   ) -> Tuple[Tuple[PoolState, ...],
                              Tuple[torch.Tensor, ...]]:
    """A sharded pool's chunk: each shard's ``step_chunk`` on its own
    engine replica (``engines``), in shard order, every argument one entry
    per shard.  Each call only enqueues its shard's work on the shard's
    device, so no shard waits on another's chunk.  ``on_shard(i)`` runs
    just before shard ``i``'s call (a contract trace opens the shard's
    section there).  Returns the shards' states and logits banks."""
    states, outs = [], []
    for i, args in enumerate(zip(engines, state, frames, lengths, active,
                                 reset, out_buf)):
        if on_shard is not None:
            on_shard(i)
        st, out = args[0].step_chunk(*args[1:], n_frames=n_frames)
        states.append(st)
        outs.append(out)
    return tuple(states), tuple(outs)


def pool_state_slot_dims(state: PoolState) -> PoolState:
    """The slot dim of every `PoolState` leaf (0, telemetry 1)."""
    return PoolState(
        layers=tuple(BatchedLayerState(0, 0, 0, 0) for _ in state.layers),
        telemetry=TelemetryState(1, 1, 1),
        cursor=0,
    )


def join_pool_state(parts: Sequence[PoolState]) -> PoolState:
    """The shards' states (host copies, or tensors on one device) joined
    back into the whole pool's, slot order kept."""
    dims = pool_state_slot_dims(parts[0])
    return _map_state(lambda d, *ts: torch.cat(ts, dim=d), dims, *parts)
