"""Device resolution and sync-free host<->device copies shared by every
entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA without a usable card
    raises: the port never falls back to the host silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
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
    ``non_blocking=True`` on the current stream, and one CUDA event is
    recorded after the copies: they are ordered after the work already
    enqueued (the chunk whose rows they hold) and before any work
    enqueued later (the next chunk, which overwrites those rows).
    ``wait()`` waits on that event only and returns the host tensors.
    On the CPU the copies are plain and ``wait()`` returns at once."""

    __slots__ = ("host", "_event")

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self.host.append(buf)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.host = [t.detach().clone() for t in tensors]

    def poll(self):
        """The host tensors if the copies have landed, else None; never
        waits."""
        if self._event is not None:
            if not self._event.query():
                return None
            self._event = None
        return self.host[0] if len(self.host) == 1 else self.host

    def wait(self):
        """The host tensors (one, or a list for several), once copied."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self.host[0] if len(self.host) == 1 else self.host

    def numpy(self):
        out = self.wait()
        return (out.numpy() if isinstance(out, torch.Tensor)
                else [t.numpy() for t in out])
