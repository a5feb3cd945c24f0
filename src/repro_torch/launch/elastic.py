"""Elastic scaling: re-lay a checkpoint onto another device count; port
of ``repro/launch/elastic.py``.

Checkpoints store full host arrays keyed by tree path, so elasticity is
a re-layout problem: build the mesh from the devices that exist,
recompute the partition specs with the same rules (any non-divisible dim
falls back to replication), and place the tree: whole on a one-device
mesh, as `ShardedTensor` leaves on a mesh of several devices (a leaf
already sharded on another mesh is gathered first).

Job-level policy (``launch/train.py``): the (process, step) -> data
mapping is deterministic, so a restarted job replays the exact stream;
the checkpoint cadence bounds lost work; on shrink, the global batch is
kept by raising the per-host batch (``rescale_batch``).
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch._device import DeviceLike
from repro_torch.distributed.sharding import (device_put, param_specs,
                                              to_shardings)
from repro_torch.launch.mesh import Mesh, compat_make_mesh


def best_mesh_for(n_devices: int, device: DeviceLike = None) -> Mesh:
    """Largest (data, model) grid <= n_devices with model <= 16 and data
    maximal, over ``device``'s type (``meta``: shape only)."""
    model = min(16, n_devices)
    while n_devices % model:
        model //= 2
    data = n_devices // model
    return compat_make_mesh((data, model), ("data", "model"), device)


def reshard(tree, mesh: Mesh, cfg=None):
    """``tree`` (host arrays, tensors or another mesh's shards) placed on
    ``mesh`` with the standard rules."""
    return device_put(tree, to_shardings(param_specs(tree, mesh, cfg), mesh))


def rescale_batch(global_batch: int, old_hosts: int, new_hosts: int,
                  per_host: int) -> Tuple[int, int]:
    """(new per-host batch, grad-accum factor) preserving the global batch."""
    if global_batch != old_hosts * per_host:
        raise ValueError(f"global batch {global_batch} != {old_hosts} hosts "
                         f"x {per_host}")
    new_per_host = math.ceil(global_batch / new_hosts)
    accum = 1
    while new_per_host > 2 * per_host:
        new_per_host = math.ceil(new_per_host / 2)
        accum *= 2
    return new_per_host, accum
