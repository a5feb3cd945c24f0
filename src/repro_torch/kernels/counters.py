"""Launch counters of the pool's sparse products, kept on the device by
the launches a layer-step already makes.

Per layer, four int64 counters, over the calls of its product (the
dense-mirror kernel or the scatter SpMV):

    calls   launches of the product
    fired   nonzero deltas it multiplied (after the capacity clip; live
            NZI entries on the scatter route)
    union   columns fired in some row of a call, once a call: the mirror
            rows or CBCSC columns a roofline charges once
    staged  what the kernel staged: on the dense mirror, a pass of up to
            ``mirror_rows_per_pass(B)`` rows stages the union of its own
            rows, so at B slots a fired row is staged up to
            ceil(B / rows a pass) times; on the scatter route every live
            entry stages its column (staged == fired)

and one byte a column, ``marks``: the product marks the columns some row
fired, and the layer's HPE launch, which follows it, adds their number
to ``union`` and clears them.  On the dense route, two more int64
counters a layer, ``CLIP_FIELDS``, follow the capacity clip's launch
(``kernels/capacity_clip.py``):

    rows      rows of delta the clip saw (B a call)
    clipped   rows it clipped: more than the capacity fired

All six sit in one ``table [L, 6]``: ``counts`` is its first four
columns, ``clip`` its last two.  No counter costs a launch, reads a
value the arithmetic writes or writes one it reads, and none syncs; a
CUDA graph of a chunk replays them with its launches.

Counting is switched on per thread: a pool with a ``PoolObservability``
runs its dispatch inside `counting()`, and only there does its engine's
step select each layer's counters around that layer's launches
(`select`).  The kernel wrappers read the selection (``selected.layer``)
and pass its pointers to the entry points, or null pointers when nothing
is selected; the kernels then run their instantiations without counting.
The switch and the selection are thread-locals rather than arguments
because the ops entry points and ``step_chunk`` keep their signatures
(callers, the benchmark among them, wrap them), and per thread because
pools tick on worker threads.  A CPU tensor counts the same numbers in
plain PyTorch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, NamedTuple, Optional, Sequence

import torch

FIELDS = ("calls", "fired", "union", "staged")
KERNELS = ("dense_mirror", "stsp_spmv")   # the products counted
CLIP = "capacity_clip"
CLIP_FIELDS = ("rows", "clipped")
MIRROR_MAX_ROWS = 32     # csrc: kMirrorMaxRows


class LayerCounters(NamedTuple):
    """One layer's views into its engine's `KernelCounters`."""

    counts: torch.Tensor   # [4] int64, FIELDS
    union: torch.Tensor    # [1] int64, counts[2:3]
    clip: torch.Tensor     # [2] int64, CLIP_FIELDS
    marks: torch.Tensor    # [Q] uint8, one per column of the deltas


class KernelCounters:
    """A pool engine's counters: ``table [L, 6]`` int64 (``counts [L,
    4]``, FIELDS, then ``clip [L, 2]``, CLIP_FIELDS) and ``marks [L, max
    Q]`` uint8 on its device; ``kernels[l]`` names layer l's product,
    ``"dense_mirror"`` or ``"stsp_spmv"``."""

    def __init__(self, n_cols: Sequence[int], kernels: Sequence[str],
                 device: torch.device):
        self.kernels = tuple(kernels)
        width = len(FIELDS) + len(CLIP_FIELDS)
        self.table = torch.zeros((len(n_cols), width), dtype=torch.int64,
                                 device=device)
        self.counts = self.table[:, :len(FIELDS)]
        self.clip = self.table[:, len(FIELDS):]
        self.marks = torch.zeros((len(n_cols), max(n_cols)),
                                 dtype=torch.uint8, device=device)
        self.layers = tuple(
            LayerCounters(self.counts[i], self.counts[i, 2:3],
                          self.clip[i], self.marks[i, :q])
            for i, q in enumerate(n_cols))


class _Selected(threading.local):
    counting: bool = False                  # inside `counting()`
    layer: Optional[LayerCounters] = None   # what the launches count into


#: the calling thread's switch and selected layer
selected = _Selected()


@contextlib.contextmanager
def counting() -> Iterator[None]:
    """Let the pool engines' steps on this thread count inside the block
    (into each engine's `KernelCounters`, where it has them)."""
    was, selected.counting = selected.counting, True
    try:
        yield
    finally:
        selected.counting = was


def select(layer: Optional[LayerCounters]) -> None:
    """Count the next product and HPE launches of this thread into
    ``layer`` (None: count nothing)."""
    selected.layer = layer


def pointers(layer: Optional[LayerCounters]):
    """What a product's launch takes for ``layer``: its counts and marks,
    or two null pointers."""
    return (None, None) if layer is None else (layer.counts, layer.marks)


def mirror_rows_per_pass(b: int) -> int:
    """Rows the dense-mirror kernel takes a pass at B = b: the least
    power of two >= min(b, 32) (its ``RB``)."""
    rows = 1
    while rows < min(b, MIRROR_MAX_ROWS):
        rows *= 2
    return rows


def _add(layer: LayerCounters, fired: torch.Tensor,
         staged: torch.Tensor) -> None:
    one = torch.ones((), dtype=torch.int64)
    layer.counts.add_(torch.stack([one, fired, torch.zeros_like(one),
                                   staged]))


def count_mirror_plain(layer: LayerCounters, ds: torch.Tensor) -> None:
    """The dense-mirror kernel's counts of one call on ``ds [B, Q]``, in
    plain PyTorch."""
    fired = ds != 0
    b, q = fired.shape
    rows = mirror_rows_per_pass(b)
    passes = fired.new_zeros((-(-b // rows) * rows, q))
    passes[:b] = fired
    staged = passes.view(-1, rows, q).any(1).sum()
    layer.marks.bitwise_or_(fired.any(0).to(torch.uint8))
    _add(layer, fired.sum(), staged)


def count_list_plain(layer: LayerCounters, idx: torch.Tensor,
                     ds_vals: torch.Tensor) -> None:
    """The scatter SpMV's counts of one call on NZI lists ``idx, ds_vals
    [B, K]``, in plain PyTorch: live entries (nonzero, column in range)
    are fired and staged."""
    q = layer.marks.shape[0]
    live = (ds_vals != 0) & (idx >= 0) & (idx < q)
    layer.marks[idx[live].long()] = 1
    n = live.sum()
    _add(layer, n, n)


def count_clip_plain(layer: LayerCounters,
                     n_dropped: torch.Tensor) -> None:
    """The capacity clip's counts of one call, in plain PyTorch, from its
    ``n_dropped [B]``: a row was clipped where some of it dropped."""
    layer.clip.add_(torch.stack([
        torch.tensor(n_dropped.shape[0], dtype=torch.int64),
        (n_dropped > 0).sum()]))


def count_marks_plain(layer: LayerCounters) -> None:
    """The HPE's half, in plain PyTorch: the marks into ``union``, then
    cleared."""
    layer.union.add_(layer.marks.sum(dtype=torch.int64))
    layer.marks.zero_()
