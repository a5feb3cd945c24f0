"""Hot-path contracts — port of ``repro/analysis/contracts.py``.

A *contract* is a set of invariants a hot-path function must satisfy:
no collectives, no host transfers, donation honoured, a float32 ceiling,
per-op-family budgets.  Functions declare theirs with the
:func:`hotpath_contract` decorator, which only registers it and costs
nothing per call; a :class:`~repro_torch.analysis.cases.ContractCase`
supplies representative arguments, and :func:`check_case` runs the
function once under an op trace (``hlo.trace``) and checks every clause
against it.

The port's functions run eagerly and update their state in place
(``serving/batched_engine.py``), so two clauses read differently here:

* ``donates`` names arguments whose tensor leaves the call must write in
  place: every leaf keeps its storage across the call, the result
  carries each one, and no two leaves of the arguments share storage
  (the reference's ``init_telemetry`` aliasing bug: one buffer bound to
  two donated leaves).  A leaf rebound to a new tensor, in the argument
  or in the result, breaks it.
* the op families and dtypes are read from the aten-op trace, with each
  kernel wrapper one entry (``hlo.kernel_region``), not from HLO text.

Every contract is declared with the reference's clauses, clause for
clause, but one that is stricter; ``tests/test_torch_contracts.py`` holds
the two registries equal but for it.  Where the port's code could not
meet a clause as it stood, the code was changed (``ops.bank_rows`` writes
with one ``index_copy_`` instead of an indexed assignment, which is a
scatter; the dense-mirror product is a kernel that keeps the mirror at
its packed dtype instead of a float64 GEMM).  The stricter clause is
``delta_spmv_dense_topk``'s ``sort: 0`` (the reference's is 1): the
reference's top_k runs under a ``lax.cond`` when a row overflowed, the
port's count and clip are one kernel that sorts nothing, so the dense
chunk meets the reference's ``sort: 0`` at any capacity.

A sharded pool's chunk (``cases``' ``step_chunk/sharded-4dev``) is one
call per shard; :func:`check_shards` adds the counterpart of the
reference's zero-collectives pin on it: no op of one shard's part
touches another shard's tensors, and each part's op histogram is the
unsharded chunk's.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import hlo


@dataclasses.dataclass(frozen=True)
class HotpathContract:
    """Declared invariants for one hot-path function.

    Attributes:
      name: registry key; also how cases refer back to the contract.
      no_collectives: the trace holds no cross-device communication op.
      no_host_transfers: the trace holds no host transfer or sync.
      donates: names of the arguments whose tensor leaves are written in
        place (see the module docstring).
      max_dtype: widest floating dtype permitted in the trace.
      forbid_ops: op families that must not appear at all.
      op_budget: per-op-family ceilings.
    """

    name: str
    no_collectives: bool = True
    no_host_transfers: bool = True
    donates: Tuple[str, ...] = ()
    max_dtype: str = "float32"
    forbid_ops: Tuple[str, ...] = ()
    op_budget: Mapping[str, int] = dataclasses.field(default_factory=dict)


# contract name -> HotpathContract.  Decorating a function registers it
# here; cases look contracts up by name.
_REGISTRY: Dict[str, HotpathContract] = {}


def hotpath_contract(
    name: str,
    *,
    no_collectives: bool = True,
    no_host_transfers: bool = True,
    donates: Sequence[str] = (),
    max_dtype: str = "float32",
    forbid_ops: Sequence[str] = (),
    op_budget: Optional[Mapping[str, int]] = None,
) -> Callable[[Any], Any]:
    """Declare and register a contract; returns the function unchanged.

    Re-registering the same name with identical clauses is a no-op; a
    conflicting re-registration raises, so two modules cannot silently
    fight over one contract."""
    contract = HotpathContract(
        name=name,
        no_collectives=no_collectives,
        no_host_transfers=no_host_transfers,
        donates=tuple(donates),
        max_dtype=max_dtype,
        forbid_ops=tuple(forbid_ops),
        op_budget=dict(op_budget or {}),
    )
    existing = _REGISTRY.get(name)
    if existing is not None and existing != contract:
        raise ValueError(
            f"hotpath_contract {name!r} already registered with different "
            f"clauses: {existing} vs {contract}")
    _REGISTRY[name] = contract

    def deco(fn: Any) -> Any:
        fn.__hotpath_contract__ = contract
        return fn

    return deco


def get_contract(name: str) -> HotpathContract:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no hotpath contract named {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_contracts() -> Dict[str, HotpathContract]:
    return dict(_REGISTRY)


@dataclasses.dataclass
class Violation:
    contract: str
    clause: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.clause}: {self.message}"


@dataclasses.dataclass
class ContractReport:
    """Result of checking one case against its contract.  ``alias_entries``
    counts the donated leaves the call wrote in place and returned."""

    case: str
    contract: str
    violations: List[Violation]
    op_histogram: Dict[str, int]
    alias_entries: int
    donated_leaves: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, Any]:
        return {
            "case": self.case,
            "contract": self.contract,
            "ok": self.ok,
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "op_histogram": dict(self.op_histogram),
            "alias_entries": self.alias_entries,
            "donated_leaves": self.donated_leaves,
        }


def check_trace(contract: HotpathContract,
                trace: hlo.OpTrace) -> List[Violation]:
    """Every clause of ``contract`` but donation, against one op trace."""
    out: List[Violation] = []

    def add(clause: str, message: str) -> None:
        out.append(Violation(contract.name, clause, message))

    if contract.no_collectives:
        hits = hlo.collective_lines(trace)
        if hits:
            add("no_collectives",
                f"{len(hits)} collective op(s), e.g. {hits[0]!r}")
    if contract.no_host_transfers:
        hits = hlo.host_transfer_lines(trace)
        if hits:
            add("no_host_transfers",
                f"{len(hits)} host transfer(s), e.g. {hits[0]!r}")
    hits = hlo.dtype_violation_lines(trace, contract.max_dtype)
    if hits:
        add("max_dtype", f"{len(hits)} op(s) exceed {contract.max_dtype}, "
                         f"e.g. {hits[0]!r}")
    histogram = hlo.op_histogram(trace)
    for op in contract.forbid_ops:
        n = histogram.get(op, 0)
        if n:
            add("forbid_ops", f"forbidden op {op!r} appears {n} time(s)")
    for op, budget in contract.op_budget.items():
        n = histogram.get(op, 0)
        if n > budget:
            add("op_budget", f"op {op!r} appears {n} time(s), budget {budget}")
    return out


def _leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of nested tuples (NamedTuples too), lists, dicts and
    dataclasses, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _donated_leaves(args: Mapping[str, Any]) -> List[Tuple[str, torch.Tensor]]:
    # empty tensors own no storage to donate
    return [(name, t) for name, arg in args.items() for t in _leaves(arg)
            if t.numel()]


def check_donation(contract: HotpathContract, args: Mapping[str, Any],
                   before: Sequence[Tuple[str, int]],
                   result: Any) -> Tuple[List[Violation], int]:
    """Donation after one call: ``args`` maps each donated argument's name
    to the object passed, ``before`` is ``(name, storage)`` of its leaves
    taken before the call.  Returns (violations, leaves written in place
    and returned)."""
    out: List[Violation] = []
    after = [(name, _storage(t)) for name, t in _donated_leaves(args)]
    if after != list(before):
        rebound = (sum(a != b for a, b in zip(before, after))
                   + abs(len(before) - len(after)))
        out.append(Violation(
            contract.name, "donation",
            f"{rebound} donated leaf/leaves of the argument rebound to new "
            f"storage"))
    returned = {_storage(t) for t in _leaves(result) if t.numel()}
    kept = sum(ptr in returned for _, ptr in before)
    if kept < len(before):
        out.append(Violation(
            contract.name, "donation",
            f"only {kept}/{len(before)} donated leaves come back in place "
            f"in the result; the rest were rebound, not written"))
    return out, kept


def check_aliasing(contract: HotpathContract,
                   before: Sequence[Tuple[str, int]]) -> List[Violation]:
    """No two donated leaves may share one storage."""
    seen: Dict[int, str] = {}
    shared = []
    for name, ptr in before:
        if ptr in seen:
            shared.append((seen[ptr], name))
        seen[ptr] = name
    if not shared:
        return []
    return [Violation(contract.name, "donation",
                      f"{len(shared)} pair(s) of donated leaves share one "
                      f"storage (e.g. in {shared[0][0]!r} and "
                      f"{shared[0][1]!r}): an in-place write to one "
                      f"clobbers the other")]


def check_shards(contract: str, trace: hlo.OpTrace,
                 shards: Sequence[frozenset],
                 histogram: Mapping[str, int]) -> List[Violation]:
    """The sharded chunk's clauses.  ``shards`` holds each shard's
    per-slot storages (state, frames, lengths, logits bank), in shard
    order; ``histogram`` is the unsharded chunk's op histogram at the
    shard's batch.  The trace must fall in one marked section per shard
    (``hlo.mark``), no op of a section may read or write another shard's
    storages (a copy between shards), and every section's op histogram
    must equal ``histogram``."""
    out: List[Violation] = []
    parts = hlo.sections(trace)
    if list(parts) != [f"shard{i}" for i in range(len(shards))]:
        return [Violation(contract, "shards",
                          f"expected one section per shard for "
                          f"{len(shards)} shards, got {list(parts)}")]
    for i, entries in enumerate(parts.values()):
        others = frozenset().union(*(s for j, s in enumerate(shards)
                                     if j != i))
        crossing = [e.line() for e in entries if e.storages & others]
        if crossing:
            out.append(Violation(
                contract, "cross_shard",
                f"shard {i}: {len(crossing)} op(s) touch another shard's "
                f"tensors, e.g. {crossing[0]!r}"))
        got = dict(hlo.op_histogram(entries))
        if got != dict(histogram):
            diff = {op: (got.get(op, 0), histogram.get(op, 0))
                    for op in set(got) | set(histogram)
                    if got.get(op, 0) != histogram.get(op, 0)}
            out.append(Violation(
                contract, "shard_histogram",
                f"shard {i}: op counts (shard, unsharded) differ: {diff}"))
    return out


def check_built(case: "ContractCase", built: "BuiltCase") -> ContractReport:  # noqa: F821
    """Run one built case once under an op trace and check every clause
    of its contract (with the case's budget overrides)."""
    contract = get_contract(case.contract)
    if case.op_budget_override:
        contract = dataclasses.replace(
            contract,
            op_budget={**contract.op_budget, **case.op_budget_override})
    bound = inspect.signature(built.fn).bind(*built.args, **built.kwargs)
    donated = {name: bound.arguments[name] for name in contract.donates}
    before = [(name, _storage(t)) for name, t in _donated_leaves(donated)]
    violations = check_aliasing(contract, before)
    result, trace = hlo.trace(built.fn, *built.args, **built.kwargs)
    violations += check_trace(contract, trace)
    if built.shards:
        violations += check_shards(contract.name, trace, built.shards,
                                   built.shard_histogram)
    kept = 0
    if contract.donates:
        found, kept = check_donation(contract, donated, before, result)
        violations += found
    return ContractReport(
        case=case.name,
        contract=contract.name,
        violations=violations,
        op_histogram=dict(hlo.op_histogram(trace)),
        alias_entries=kept,
        donated_leaves=len(before),
    )


def check_case(case: "ContractCase") -> ContractReport:  # noqa: F821
    """Build one case's arguments afresh and check it."""
    return check_built(case, case.build())

