"""Layer-stack execution; port of ``repro/models/scan.py``.

The reference runs a stack with ``jax.lax.scan`` unless ``unrolled()``
is on (its dry-run probes); eager PyTorch has one way to run it, a
Python loop over the leading ``[L]`` axis, so both settings run the
same loop.  ``unrolled`` and ``unroll_active`` keep their names; the
port's dry run needs neither, since its count sees every layer.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree

_UNROLL = False


@contextlib.contextmanager
def unrolled(enable: bool = True):
    global _UNROLL
    prev = _UNROLL
    _UNROLL = enable
    try:
        yield
    finally:
        _UNROLL = prev


def unroll_active() -> bool:
    return _UNROLL


def scan_layers(body: Callable, carry, xs) -> Tuple[Any, Any]:
    """``jax.lax.scan(body, carry, xs)``: ``body(carry, x_i) -> (carry,
    y_i)`` over the leading axis of every leaf of ``xs``; the ``y_i`` are
    stacked (``None`` when the body emits none)."""
    n = _tree.leaves(xs)[0].shape[0]
    ys = []
    for i in range(n):
        carry, y = body(carry, _tree.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, _tree.tree_map(lambda *a: torch.stack(a), *ys)
    return carry, None


def remat(body: Callable) -> Callable:
    """``jax.checkpoint(body)``: the backward pass recomputes the body's
    activations instead of keeping them."""
    def wrapped(carry, x):
        return checkpoint(body, carry, x, use_reentrant=False)
    return wrapped
