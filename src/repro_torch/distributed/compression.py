"""Gradient compression for a cross-group reduction; port of
``repro/distributed/compression.py``.

Error-feedback int8 compression: quantize (gradient + residual) to int8
per tensor before the all-reduce, and keep the quantization error as the
member's residual for the next step (the EF-SGD family: unbiased over
time).  Also top-k sparsification with error feedback: only the largest
``frac`` of each tensor travels, the rest accumulates locally.

A library, as in the reference: no trainer calls it.  The port is
single-controller, so ``compressed_psum`` takes every member's gradient
and residual trees at once and returns every member's result, where the
reference runs once per member under ``shard_map`` with a named axis.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch import _tree


def _per_leaf(fn: Callable, grads, residual, n_out: int):
    """``fn(g, r)`` on every leaf of ``grads`` and the leaf of ``residual``
    at the same path; returns ``n_out`` trees shaped like ``grads``."""
    r = dict(_tree.leaves_with_path(residual))
    out = {path: fn(g, r[path]) for path, g in _tree.leaves_with_path(grads)}
    return tuple(_tree.map_with_path(lambda path, _: out[path][i], grads)
                 for i in range(n_out))


def ef_int8_compress(grads, residual):
    """(grads + residual) -> (int8 payload, scales, new residual).  The
    scale is max|x| / 127 (at least 1e-12 / 127); rounding is half to
    even, as ``jnp.round``."""
    def one(g, r):
        x = g.to(torch.float32) + r
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale, x - q.to(torch.float32) * scale

    return _per_leaf(one, grads, residual, 3)


def ef_int8_decompress(payload, scales):
    return _tree.tree_map(lambda q, s: q.to(torch.float32) * s, payload,
                          scales)


def init_residual(grads):
    return _tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def ef_topk_compress(grads, residual, frac: float = 0.01):
    """Keep the largest-|.| ``frac`` of each tensor: every element at or
    above the k-th largest magnitude (ties keep more than k, as in the
    reference); the rest stays in the residual."""
    def one(g, r):
        x = (g.to(torch.float32) + r).reshape(-1)
        k = max(int(x.numel() * frac), 1)
        mag = torch.abs(x)
        thresh = torch.sort(mag).values[-k]
        sent = torch.where(mag >= thresh, x, 0.0)
        return sent.reshape(g.shape), (x - sent).reshape(g.shape)

    return _per_leaf(one, grads, residual, 2)


def _sum_in_order(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x_0 + x_1 + ...`` on the first member's device."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return acc


def compressed_psum(grads: Sequence[Any], residual: Sequence[Any],
                    mode: str = "int8") -> Tuple[List[Any], List[Any]]:
    """An all-reduce (sum) over the group whose members' gradient and
    residual trees are ``grads[i]``, ``residual[i]``, with error-feedback
    compression; returns (each member's reduced tree, each member's new
    residual).  int8: the int32 sum of the payloads is exact, and the
    scales are averaged; topk: the sparsified trees are summed; any other
    mode sums the gradients uncompressed (residuals unchanged).  Each
    member's result lies on its own gradients' devices."""
    n = len(grads)
    if mode == "int8":
        q, s, residual = zip(*(ef_int8_compress(g, r)
                               for g, r in zip(grads, residual)))
        summed = _tree.tree_map(
            lambda *t: _sum_in_order([x.to(torch.int32) for x in t]), *q)
        s_mean = _tree.tree_map(lambda *t: _sum_in_order(t) / n, *s)
        out = _tree.tree_map(lambda t, sc: t.to(torch.float32) * sc, summed,
                             s_mean)
    elif mode == "topk":
        sent, residual = zip(*(ef_topk_compress(g, r)
                               for g, r in zip(grads, residual)))
        out = _tree.tree_map(lambda *t: _sum_in_order(t), *sent)
    else:
        out = _tree.tree_map(lambda *t: _sum_in_order(t), *grads)
    outs = [_tree.tree_map(lambda o, g: o.to(g.device, copy=True), out, g)
            for g in grads]
    return outs, list(residual)
