"""Device meshes; port of ``repro/launch/mesh.py``.

A mesh is a plain description: axis names, their sizes, and the devices
it spans in row-major order.  Shapes follow the reference:
  single-pod: (16, 16)        -> ("data", "model")
  multi-pod:  (2, 16, 16)     -> ("pod", "data", "model")

A mesh built for the ``meta`` device is shape-only (the reference's
``AbstractMesh``): the partition rules read its shape, and nothing can be
placed on it.  The production meshes are shape-only: no single host of
the port holds 256 cards.

``emulated_devices(n)`` makes ``n`` copies of the one host device, or of
``cuda:0``, visible to mesh building inside a ``with`` block: the
counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``.  The serving pool
runs its slot shards as logical shards on one device that way, so code
that places shards never assumes two shards' devices differ.

``data_axes()`` returns the axes a global batch shards over (pod folds
into data parallelism); ``model_axis()`` the tensor-parallel axis;
``replica_devices()`` the device that computes each data replica's
slice of a sharded train step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()    # () = shape only

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _visible(device: torch.device):
    """The devices a mesh over ``device``'s type may span: every visible
    card for ``cuda``, the one host device for ``cpu``."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def visible_devices(device: DeviceLike = None):
    """The devices a mesh over ``device``'s type may span now (copies
    inside ``emulated_devices``)."""
    return _visible(resolve_device(device))


@contextlib.contextmanager
def emulated_devices(n: int):
    """Within the block, ``n`` copies of the host device (``cpu``) or of
    ``cuda:0`` are the visible devices of either type; the real
    ``_visible`` is restored on exit.  A mesh built inside keeps its
    devices after the block."""
    global _visible
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    real = _visible

    def widened(device: torch.device):
        if device.type == "cuda":
            return [torch.device("cuda", 0)] * n
        return [torch.device(device.type)] * n

    _visible = widened
    try:
        yield
    finally:
        _visible = real


def compat_make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` devices of
    ``device``'s type (``cuda`` by default); shape-only for ``meta``.
    Raises when fewer devices are visible."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    device = resolve_device(device)
    if device.type == "meta":
        return Mesh(axes, shape)
    avail = _visible(device)
    n = math.prod(shape)
    if n > len(avail):
        raise ValueError(
            f"requested a {n}-device mesh {dict(zip(axes, shape))} but only "
            f"{len(avail)} {device.type} device(s) are visible")
    return Mesh(axes, shape, tuple(avail[:n]))


_ACTIVE = None


def active_mesh():
    """The mesh of the innermost ``mesh_context``, or None."""
    return _ACTIVE


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """Activate ``mesh`` within the block: ``distributed.hints`` resolves
    its annotations against it, and on a mesh of cards its first card is
    the current CUDA device."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        if mesh.devices and mesh.devices[0].type == "cuda":
            with torch.cuda.device(mesh.devices[0]):
                yield mesh
        else:
            yield mesh
    finally:
        _ACTIVE = prev


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, "meta")


def make_host_mesh(n_data: int = 2, n_model: int = 2) -> Mesh:
    """Small mesh over host devices.  The host is one device to PyTorch,
    so only ``(1, 1)`` can be built; larger shapes raise."""
    return compat_make_mesh((n_data, n_model), ("data", "model"), "cpu")


def make_data_mesh(n_data: int = 1, device: DeviceLike = None) -> Mesh:
    """1-D ``("data",)`` mesh over the first ``n_data`` cards: the serving
    pool's slot-dimension data parallelism.  Raises when fewer cards are
    visible."""
    if n_data < 1:
        raise ValueError(f"n_data must be >= 1, got {n_data}")
    return compat_make_mesh((n_data,), ("data",), device)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh: Mesh) -> str:
    return "model"


def replica_devices(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The compute device of each data replica: the mesh device at each
    coordinate of the data axes (row-major) with every other axis at 0."""
    keep = [a in data_axes(mesh) for a in mesh.axis_names]
    return tuple(dev for coord, dev in zip(
        itertools.product(*map(range, mesh.axis_sizes)), mesh.devices)
        if all(k or c == 0 for k, c in zip(keep, coord)))


def axis_size(mesh: Mesh, *names: str) -> int:
    out = 1
    for n in names:
        if n in mesh.axis_names:
            out *= mesh.shape[n]
    return out
