"""Op traces of the hot paths — the port's counterpart of
``repro/analysis/hlo.py`` (the file name is kept so the port mirrors the
reference file for file).

The reference asserts its contracts against the optimized HLO that XLA
compiles for a jitted function.  The port runs eagerly and has no
compiled module: its "compiled form" is the trace of aten ops that one
call issues, recorded under a ``TorchDispatchMode`` (:func:`trace`).  It
is recorded alike on the CPU and on the card.

**Kernel regions.**  Every kernel wrapper of ``repro_torch.kernels`` is
wrapped in :func:`kernel_region`.  Inside a trace, one call records one
entry, ``kernel:<name>``, with its inputs' and outputs' dtypes and
shapes, and hides the ops it issues itself (the plain version's on the
CPU, the output allocations on the card), as a Pallas call is one
custom-call in HLO.  The float64 inside the HPE's and the dense mirror's
plain versions is internal to a kernel, as it is on the card.

**Families.**  The reference's op families, in aten ops:

================================  =============================================
family                            aten ops
================================  =============================================
``dot``                           mm, addmm, bmm, matmul, mv, dot, and the
                                  ``kernel:dense_mirror`` region
``sort``                          sort, topk, argsort, kthvalue
``scatter``                       scatter*, index_put, index_add
``dynamic-update-slice``          index_copy, slice_scatter, copy_ into a view
``gather``                        gather, index_select, index.Tensor
``transpose``                     a transposed view materialised: clone,
                                  contiguous, copy_ or _to_copy from a view
                                  whose stride order differs from the result's
================================  =============================================

A transposed *view* feeding ``mm`` (the head's ``h @ w.T``) moves no
data and is not a transpose, as XLA's layout assignment makes the same
thing free.  Collectives are the ops of the ``c10d`` and
``_c10d_functional`` namespaces; host transfers are
``_local_scalar_dense`` (``.item()``, ``int(t)``, ``.tolist()``),
``nonzero`` and any copy whose destination is the CPU and whose source is
not.

**Sections.**  A case whose call runs several parts (the sharded pool's
chunk, one per shard) marks where each begins with :func:`mark`; the
trace's :func:`sections` split its entries there, and every entry records
the storages of the tensors it touched, so a checker can tell which
part's tensors an op reads or writes.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import (
    Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple,
)

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

COLLECTIVE_NAMESPACES: Tuple[str, ...] = ("c10d", "_c10d_functional",
                                          "c10d_functional")
HOST_TRANSFER_OPS: Tuple[str, ...] = ("_local_scalar_dense", "nonzero")
# aten op (overload packet name, trailing "_" of in-place forms dropped)
# -> family
OP_FAMILIES = {
    **{op: "dot" for op in ("mm", "addmm", "bmm", "matmul", "mv", "dot")},
    **{op: "sort" for op in ("sort", "topk", "argsort", "kthvalue")},
    **{op: "scatter" for op in ("scatter", "scatter_add", "scatter_reduce",
                                "index_put", "_index_put_impl",
                                "index_add")},
    **{op: "dynamic-update-slice" for op in ("index_copy", "slice_scatter")},
    **{op: "gather" for op in ("gather", "index_select", "index")},
}
# kernel regions that stand for an op family of the reference's HLO
KERNEL_FAMILIES = {"dense_mirror": ("dot",)}
# copies that materialise their source: a transpose if the source is a
# view in another stride order
_COPY_OPS = ("clone", "contiguous", "copy", "_to_copy")
_WIDE_DTYPES = (torch.float64, torch.complex128)
_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
                torch.float16: "f16", torch.bfloat16: "bf16",
                torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
                torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
                torch.complex64: "c64", torch.complex128: "c128"}


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: str

    def __str__(self) -> str:
        name = _DTYPE_NAMES.get(self.dtype, str(self.dtype))
        return f"{name}[{','.join(map(str, self.shape))}]@{self.device}"


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """One traced call: an aten op (``aten.mm``) or a kernel region
    (``kernel:dense_mirror``)."""

    op: str
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    families: Tuple[str, ...] = ()
    host_transfer: bool = False
    collective: bool = False
    # storages of the tensors the call read or wrote
    storages: FrozenSet[int] = frozenset()

    def line(self) -> str:
        tags = "".join(f" #{f}" for f in self.families)
        outs = ", ".join(map(str, self.outputs)) or "()"
        ins = ", ".join(map(str, self.inputs))
        return f"{outs} = {self.op}({ins}){tags}"


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _metas(tree: Any) -> Tuple[TensorMeta, ...]:
    return tuple(TensorMeta(t.dtype, tuple(t.shape), t.device.type)
                 for t in _tensors(tree))


def _storages(tree: Any) -> FrozenSet[int]:
    return frozenset(t.untyped_storage().data_ptr() for t in _tensors(tree)
                     if t.numel())


def _stride_order(t: torch.Tensor) -> Tuple[int, ...]:
    """Dimensions of extent > 1, outermost (largest stride) first."""
    dims = [d for d in range(t.dim()) if t.shape[d] > 1]
    return tuple(sorted(dims, key=lambda d: -t.stride(d)))


def _transposes(src: Any, dst: Any) -> bool:
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src._is_view() and src.shape == dst.shape
            and _stride_order(src) != _stride_order(dst))


def _aten_entry(func, args, kwargs, out) -> OpEntry:
    packet = func.overloadpacket.__name__
    base = packet[:-1] if packet.endswith("_") else packet  # in place
    families = []
    if base in OP_FAMILIES:
        families.append(OP_FAMILIES[base])
    host = packet in HOST_TRANSFER_OPS
    if base in _COPY_OPS:
        if base == "copy":
            dst, src = args[0], args[1]
            if dst._is_view():
                families.append("dynamic-update-slice")
        else:
            src, dst = args[0], out
        if _transposes(src, dst):
            families.append("transpose")
        host = host or (isinstance(src, torch.Tensor)
                        and isinstance(dst, torch.Tensor)
                        and dst.device.type == "cpu"
                        and src.device.type != "cpu")
    return OpEntry(
        op=f"{func.namespace}.{packet}",
        inputs=_metas((args, kwargs)), outputs=_metas(out),
        families=tuple(families), host_transfer=host,
        collective=func.namespace in COLLECTIVE_NAMESPACES,
        storages=_storages((args, kwargs, out)))


class OpTrace(TorchDispatchMode):
    """Records every aten op issued on this thread while it is active
    (``with OpTrace() as t: ...``), one :class:`OpEntry` each, kernel
    regions as one entry each."""

    def __init__(self):
        super().__init__()
        self.entries: List[OpEntry] = []
        self._hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self.entries.append(_aten_entry(func, args, kwargs, out))
        return out

    def kernel_call(self, name: str, fn: Callable, args, kwargs):
        self._hidden += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._hidden -= 1
        if not self._hidden:
            self.entries.append(OpEntry(
                op=f"kernel:{name}", inputs=_metas((args, kwargs)),
                outputs=_metas(out), families=KERNEL_FAMILIES.get(name, ()),
                storages=_storages((args, kwargs, out))))
        return out


def _active_trace() -> Optional[OpTrace]:
    if not torch._C._len_torch_dispatch_stack():    # the common case
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpTrace):
            return mode
    return None


def kernel_region(name: str):
    """Decorate a kernel wrapper: inside a trace its call is one entry,
    ``kernel:<name>``; outside one it costs a look at the length of the
    dispatch-mode stack."""
    def deco(fn):
        @functools.wraps(fn)
        def region(*args, **kwargs):
            tracer = _active_trace()
            if tracer is None:
                return fn(*args, **kwargs)
            return tracer.kernel_call(name, fn, args, kwargs)
        return region
    return deco


def mark(label: str) -> None:
    """Inside a trace, open the section ``label`` (a ``mark:<label>``
    entry, in no family and in no histogram); outside one, nothing."""
    tracer = _active_trace()
    if tracer is not None:
        tracer.entries.append(OpEntry(op=f"mark:{label}", inputs=(),
                                      outputs=()))


def sections(t: OpTrace) -> Dict[str, List[OpEntry]]:
    """The trace's entries by the section their last :func:`mark` opened
    (entries before the first mark under ``""``, if any)."""
    out: Dict[str, List[OpEntry]] = {}
    label = ""
    for e in t.entries:
        if e.op.startswith("mark:"):
            label = e.op[len("mark:"):]
            out[label] = []
        else:
            out.setdefault(label, []).append(e)
    return out


def trace(fn: Callable, *args, **kwargs) -> Tuple[Any, OpTrace]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpTrace`:
    (its result, the trace)."""
    with OpTrace() as t:
        out = fn(*args, **kwargs)
    return out, t


# -- scanners (the reference's names; they take a trace, not HLO text) --------


def collective_lines(t: OpTrace) -> List[str]:
    """Entries of a cross-device collective."""
    return [e.line() for e in t.entries if e.collective]


def host_transfer_lines(t: OpTrace) -> List[str]:
    """Entries that move data to the host or wait for the device."""
    return [e.line() for e in t.entries if e.host_transfer]


def op_histogram(t: Any) -> Counter:
    """Entries (of a trace, or a list of them) by family; an aten op of no
    family under its own name, a kernel region under its name and its
    families.  Section marks are not counted."""
    counts: Counter = Counter()
    for e in getattr(t, "entries", t):
        if e.op.startswith("mark:"):
            continue
        if e.op.startswith("kernel:") or not e.families:
            counts[e.op] += 1
        for f in e.families:
            counts[f] += 1
    return counts


def count_ops(t: OpTrace, op: str) -> int:
    """Occurrences of one op family (or op name)."""
    return op_histogram(t).get(op, 0)


def dtype_violation_lines(t: OpTrace, max_dtype: str = "float32"
                          ) -> List[str]:
    """Entries with an input or output wider than ``max_dtype``: float64
    or complex128 under the float32 ceiling (integer bookkeeping is always
    allowed).  A float64 ceiling disables the check."""
    if max_dtype in ("float64", "f64", None):
        return []
    return [e.line() for e in t.entries
            if any(m.dtype in _WIDE_DTYPES for m in e.inputs + e.outputs)]

