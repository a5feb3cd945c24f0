"""Device resolution and sync-free host<->device copies shared by every
entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA without a usable card
    raises: the port never falls back to the host silently.  A ``cuda``
    without an index resolves to the current card, ``cuda:<index>``, so
    that two resolved devices name one card exactly when they are
    ``==``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch "
                "versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_full_fp32_matmul(device: torch.device) -> None:
    """Raise if fp32 matmuls on ``device`` would run in TF32: the port's
    parity checks (pool vs batch-1, card vs host) assume PyTorch's
    default full-precision fp32 GEMMs."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the port's fp32 "
            "matmuls must run in full fp32 (PyTorch's default)")


def as_tensor(x, dtype: torch.dtype, device: Optional[torch.device]):
    """numpy / list / tensor -> tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a host sync.

    A plain ``torch.as_tensor(arr, device="cuda")`` copies from pageable
    memory and then synchronizes the stream, so it waits for every chunk
    still in flight.  On a card the array is staged in pinned memory and
    copied with ``non_blocking=True`` on the current stream: ordered
    before whatever is enqueued next, never waiting for what came
    before.  On the CPU it is a plain copy."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return src.clone()
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


class HostCopy:
    """Device->host copies of ``tensors``, enqueued at construction.

    On a card each tensor is copied into a pinned host buffer with
    ``non_blocking=True`` on its device's current stream, and one CUDA
    event is recorded on each device's stream after its copies: they are
    ordered after the work already enqueued there (the chunk whose rows
    they hold) and before any work enqueued later (the next chunk, which
    overwrites those rows).  ``wait()`` waits on those events only and
    returns the host tensors.  On the CPU the copies are plain and
    ``wait()`` returns at once."""

    __slots__ = ("host", "_events")

    def __init__(self, *tensors: torch.Tensor):
        self._events = []
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            devices = []
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self.host.append(buf)
                if t.device not in devices:
                    devices.append(t.device)
            for dev in devices:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                self._events.append(event)
        else:
            self.host = [t.detach().clone() for t in tensors]

    def _result(self):
        return self.host[0] if len(self.host) == 1 else self.host

    def poll(self):
        """The host tensors if the copies have landed, else None; never
        waits."""
        if not all(event.query() for event in self._events):
            return None
        self._events = []
        return self._result()

    def wait(self):
        """The host tensors (one, or a list for several), once copied."""
        for event in self._events:
            event.synchronize()
        self._events = []
        return self._result()

    def numpy(self):
        out = self.wait()
        return (out.numpy() if isinstance(out, torch.Tensor)
                else [t.numpy() for t in out])
