"""Static guarded-by/lockset checking for the port — port of
``repro/analysis/concurrency.py`` (the runtime half is
`repro_torch.analysis.lockorder`).

A class states its guarded fields ONCE, in a class-body table::

    class SessionPool:
        _guarded_by_ = {"_shards": "_state_lock", "_pending": "_state_lock"}

and the pass walks every method of the class and tracks the *lock
context* of each ``self.<field>`` read/write: lexically inside a
``with self.<lock>:`` block (multi-item withs count), or inside a helper
method whose every intra-class call site holds the lock (resolved ONE
call hop deep: a chain the analyzer cannot follow is a chain a reader
cannot follow either).  ``__init__`` is exempt (the object is not shared
until construction returns).  Audited exceptions are silenced in place
with the shared pragma (`repro_torch.analysis.lint` syntax)::

    n = len(self._pending)  # lint: allow(guarded-by) driver-thread-only

A second rule, **await-under-lock**, flags an ``await`` lexically inside
a ``with self.<...lock...>:`` block of an ``async def`` under
``src/repro_torch/serving/``: parking a coroutine while holding a lock
the tick worker needs stalls the whole pool for the await's duration.

A shallow ``ast`` walk, like the reference's: no aliasing, no
cross-class tracking (``checkpoint.py`` taking ``pool._state_lock``
around its reads of ``pool._shards`` is checked by the concurrency
stress tests, not by this pass).  The pass reads every ``.py`` under
``src/repro_torch/``; the reference's reads every file under ``src/``,
this package included.  CLI:
``python -m repro_torch.analysis.lint --concurrency``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.analysis.lint import (
    PORT,
    REPO_ROOT,
    LintFinding,
    _allowed_rules,
    _RawHit,
    _under,
    repo_files,
)

__all__ = [
    "CONCURRENCY_RULE_NAMES",
    "GUARD_TABLE_NAME",
    "check_repo",
    "check_source",
]

#: the class-body declaration the guarded-by pass keys on.
GUARD_TABLE_NAME = "_guarded_by_"

CONCURRENCY_RULE_NAMES = ("guarded-by", "await-under-lock")

#: methods whose body runs before/after the object is shared.
_EXEMPT_METHODS = frozenset({"__init__", "__del__"})


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.<attr>`` -> attr name, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _guard_table(cls: ast.ClassDef) -> Tuple[Optional[Dict[str, str]],
                                             List[_RawHit]]:
    """Parse the class's ``_guarded_by_`` literal; (None, []) if absent."""
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        if not any(isinstance(t, ast.Name) and t.id == GUARD_TABLE_NAME
                   for t in targets):
            continue
        try:
            table = ast.literal_eval(stmt.value)
        except (ValueError, SyntaxError):
            table = None
        if (not isinstance(table, dict)
                or not all(isinstance(k, str) and isinstance(v, str)
                           for k, v in table.items())):
            return None, [_RawHit(
                stmt.lineno,
                f"class {cls.name}: {GUARD_TABLE_NAME} must be a literal "
                "{field: lock_attr} dict of strings (the analyzer reads "
                "it with ast.literal_eval)")]
        return table, []
    return None, []


class _AccessCollector:
    """Walk one method, tracking the set of self-locks lexically held."""

    def __init__(self, locks: FrozenSet[str]):
        self.locks = locks
        # (node, field, held, is_write) for self.<field> accesses:
        self.accesses: List[Tuple[ast.AST, str, FrozenSet[str], bool]] = []
        # (node, held) for every intra-class self.<meth>() call site:
        self.calls: List[Tuple[str, FrozenSet[str]]] = []
        # await nodes with >= 1 self-lock held:
        self.awaits_under_lock: List[Tuple[ast.AST, FrozenSet[str]]] = []

    def visit(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                name = _self_attr(item.context_expr)
                if name in self.locks:
                    acquired.add(name)
                self.visit(item.context_expr, held)
            inner = held | frozenset(acquired)
            for child in node.body:
                self.visit(child, inner)
            return
        attr = _self_attr(node)
        if attr is not None:
            self.accesses.append(
                (node, attr, held,
                 isinstance(node.ctx, (ast.Store, ast.Del))))
        if (isinstance(node, ast.Call)
                and (callee := _self_attr(node.func)) is not None):
            self.calls.append((callee, held))
        if isinstance(node, ast.Await):
            if held:
                self.awaits_under_lock.append((node, held))
        for child in ast.iter_child_nodes(node):
            self.visit(child, held)


def _check_guarded_by(tree: ast.AST, src: str) -> List[_RawHit]:
    hits: List[_RawHit] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        table, bad = _guard_table(cls)
        hits.extend(bad)
        if not table:
            continue
        locks = frozenset(table.values())
        methods = [m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        per_method: Dict[str, _AccessCollector] = {}
        for m in methods:
            col = _AccessCollector(locks)
            for stmt in m.body:
                col.visit(stmt, frozenset())
            per_method[m.name] = col
        # one-hop call-site resolution: locks held at EVERY intra-class
        # call site of each method (None = never called intra-class).
        callsite_locks: Dict[str, Optional[FrozenSet[str]]] = {}
        for col in per_method.values():
            for callee, held in col.calls:
                if callee in per_method:
                    prev = callsite_locks.get(callee)
                    callsite_locks[callee] = (held if prev is None
                                              else prev & held)
        for m in methods:
            if m.name in _EXEMPT_METHODS:
                continue
            inherited = callsite_locks.get(m.name) or frozenset()
            for node, field, held, is_write in per_method[m.name].accesses:
                lock = table.get(field)
                if lock is None or lock in held or lock in inherited:
                    continue
                hits.append(_RawHit(
                    node.lineno,
                    f"{'write to' if is_write else 'read of'} "
                    f"`self.{field}` in {cls.name}.{m.name} without "
                    f"holding `self.{lock}` ({GUARD_TABLE_NAME} declares "
                    f"{field!r} guarded by {lock!r}); wrap it in `with "
                    f"self.{lock}:` — or, for an audited single-thread "
                    f"access, annotate `# lint: allow(guarded-by)`"))
    return hits


def _check_await_under_lock(tree: ast.AST, src: str) -> List[_RawHit]:
    hits: List[_RawHit] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        locky = frozenset(
            attr for node in ast.walk(fn)
            if isinstance(node, (ast.With, ast.AsyncWith))
            for item in node.items
            if (attr := _self_attr(item.context_expr)) is not None
            and "lock" in attr.lower())
        if not locky:
            continue
        col = _AccessCollector(locky)
        for stmt in fn.body:
            col.visit(stmt, frozenset())
        for node, held in col.awaits_under_lock:
            hits.append(_RawHit(
                node.lineno,
                f"`await` inside `with self.{sorted(held)[0]}:` in "
                f"coroutine `{fn.name}`: parking the event loop while "
                "holding a lock the tick worker contends stalls every "
                "pool thread for the await's duration; release the lock "
                "before awaiting (copy what you need out first)"))
    return hits


_GUARDED_APPLIES = _under(PORT)
_AWAIT_APPLIES = _under(PORT + "serving/")

_CHECKS = (
    ("guarded-by", _GUARDED_APPLIES, _check_guarded_by),
    ("await-under-lock", _AWAIT_APPLIES, _check_await_under_lock),
)


def check_source(src: str, path: str) -> List[LintFinding]:
    """Run the concurrency rules over one source string at ``path``."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, "syntax",
                            f"unparseable: {e.msg}")]
    src_lines = src.splitlines()
    findings: List[LintFinding] = []
    for name, applies, check in _CHECKS:
        if not applies(path):
            continue
        for hit in check(tree, src):
            if name in _allowed_rules(src_lines, hit.line):
                continue
            findings.append(LintFinding(path, hit.line, name, hit.message))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def check_paths(paths, root: Optional[Path] = None) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for p in paths:
        rel = p.relative_to(root).as_posix() if root else str(p)
        findings.extend(check_source(p.read_text(), rel))
    return findings


def check_repo(root: Path = REPO_ROOT) -> List[LintFinding]:
    """Concurrency rules over every .py under src/repro_torch/ (the same
    file set as the port's AST rules)."""
    return check_paths(repo_files(root), root=root)
