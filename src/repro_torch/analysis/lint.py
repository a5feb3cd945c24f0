"""Repo-specific AST lint rules for the port — port of
``repro/analysis/lint.py``.

Each rule encodes a bug the reference has already paid for, restated in
PyTorch's idiom; the docstring of every rule names the incident and what
it became here.  The pass is deliberately shallow — plain ``ast`` walks,
no type inference — because each rule targets one syntactic shape with a
known safe alternative.  False positives are silenced in place with a
pragma comment on the offending line (or the line above)::

    y = buf.index_copy(0, i, v)  # lint: allow(eager-scatter) one-off, off the hot path

The rules read every ``.py`` under ``src/repro_torch/`` (`repo_files`);
the reference's own pass (``python -m tools.lint --ast``) reads every
file under ``src/``, this package included.  CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint [--ast] [--concurrency]

(``--concurrency`` runs `repro_torch.analysis.concurrency`; with no flag
both passes run.)
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

_PRAGMA_RE = re.compile(r"lint:\s*allow\(([a-z0-9\-,\s]+)\)")

# Calls that allocate a tensor, for the aliased-donation rule.
_ALLOC_FNS = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like",
              "full_like", "empty_like"}

# Out-of-place updates that copy the whole buffer they update.
_SCATTER_FNS = {"scatter", "index_put", "index_copy", "masked_scatter"}

# Calls that wait for the device and copy to the host.
_BLOCKING_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}

_WALLCLOCK_ATTRS = {"time", "perf_counter", "monotonic", "process_time"}

#: the repository root (``src/repro_torch/analysis/lint.py`` -> root)
REPO_ROOT = Path(__file__).resolve().parents[3]


@dataclasses.dataclass
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Rule:
    name: str
    doc: str
    applies_to: Callable[[str], bool]
    check: Callable[[ast.AST, str], List["_RawHit"]]


@dataclasses.dataclass
class _RawHit:
    line: int
    message: str


def _attr_name(node: ast.AST) -> Optional[str]:
    """Trailing attribute/function name of a call target, if any."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _mentions(fn: ast.AST, names: Set[str]) -> bool:
    """True if any decorator of ``fn`` names one of ``names`` (covers
    ``@torch.compile``, ``@torch.compile(mode=...)`` and
    ``@functools.partial(torch.compile, ...)``)."""
    for deco in getattr(fn, "decorator_list", ()):
        for node in ast.walk(deco):
            if _attr_name(node) in names:
                return True
    return False


def _enclosing_functions(tree: ast.AST) -> Dict[ast.AST, Optional[ast.AST]]:
    """Map every node to its innermost enclosing function def (or None)."""
    parent: Dict[ast.AST, Optional[ast.AST]] = {}

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        parent[node] = fn
        inner = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) else fn
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(tree, None)
    return parent


# -- rule: iota-gather --------------------------------------------------------


def _check_iota_gather(tree: ast.AST, src: str) -> List[_RawHit]:
    """Batch-iota advanced indexing, ``x[arange(B), i]``.

    The reference's incident: the iota form made GSPMD insert an
    all-gather and an all-reduce into every scan iteration of the sharded
    pool.  The shape is unchanged in the port; ``torch.gather`` /
    ``take_along_dim`` (``ops.gather_frames``) reads each row's own
    element without the index tensor the iota form builds."""
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Subscript):
            continue
        sl = node.slice
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for e in elts:
            if isinstance(e, ast.Call) and _attr_name(e.func) == "arange":
                hits.append(_RawHit(
                    node.lineno,
                    "batch-iota advanced indexing (`x[arange(B), i]`); use "
                    "`torch.gather` / `take_along_dim` (see "
                    "ops.gather_frames)"))
                break
    return hits


# -- rule: eager-scatter ------------------------------------------------------


def _check_eager_scatter(tree: ast.AST, src: str) -> List[_RawHit]:
    """An out-of-place scatter on the serving host path.

    The reference's incident was an eager ``.at[].set`` outside jit,
    which copied the whole buffer per call.  In PyTorch every
    out-of-place ``.scatter(`` / ``.index_put(`` / ``.index_copy(`` /
    ``.masked_scatter(`` returns a new tensor, so it copies the whole
    buffer it updates, eager or not; the in-place forms (``index_copy_``
    and friends) write only the rows they name."""
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SCATTER_FNS):
            hits.append(_RawHit(
                node.lineno,
                f"out-of-place `.{node.func.attr}(` copies the whole buffer "
                f"per call on the serving host path; use "
                f"`.{node.func.attr}_(` on the buffer, or mark the intent "
                f"with a pragma"))
    return hits


# -- rule: aliased-donation ---------------------------------------------------


def _check_aliased_donation(tree: ast.AST, src: str) -> List[_RawHit]:
    """One allocated tensor bound into several fields of one call.

    The reference's init_telemetry bug: ``z = jnp.zeros(...)`` passed as
    all three TelemetryState fields made XLA reject donation of the whole
    state.  In the port the state is updated in place, so such fields
    alias each other: an in-place update of one writes the others."""
    hits = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        alloc_vars: Set[str] = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _attr_name(node.value.func) in _ALLOC_FNS):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        alloc_vars.add(tgt.id)
        if not alloc_vars:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            uses: Dict[str, int] = {}
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in alloc_vars:
                    uses[arg.id] = uses.get(arg.id, 0) + 1
            for var, n in uses.items():
                if n >= 2:
                    hits.append(_RawHit(
                        node.lineno,
                        f"tensor {var!r} bound into {n} fields of one call: "
                        "the fields alias one storage, so an in-place update "
                        "of one writes the others (the init_telemetry bug); "
                        "allocate one tensor per field"))
    return hits


# -- rule: blocking-in-driver -------------------------------------------------


def _check_blocking_in_driver(tree: ast.AST, src: str) -> List[_RawHit]:
    """Sync points inside the async driver's coroutines.

    The async front-end overlaps host scheduling with device compute;
    one ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``torch.cuda.synchronize`` / ``float(device_val)`` in a coroutine
    waits for the device and stalls the whole event loop with it."""
    hits = []
    enclosing = _enclosing_functions(tree)

    def innermost_def(node: ast.AST) -> Optional[ast.AST]:
        fn = enclosing.get(node)
        while isinstance(fn, ast.Lambda):
            fn = enclosing.get(fn)
        return fn

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = innermost_def(node)
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        name = _attr_name(node.func)
        if isinstance(node.func, ast.Attribute) and name in _BLOCKING_ATTRS:
            hits.append(_RawHit(
                node.lineno,
                f"`.{name}()` inside coroutine `{fn.name}`: waits for the "
                "device on the event loop; fetch through the boundary's "
                "staged copies (or run it in an executor)"))
        elif (isinstance(node.func, ast.Name) and node.func.id == "float"
              and node.args
              and isinstance(node.args[0], (ast.Subscript, ast.Attribute,
                                            ast.Call))):
            hits.append(_RawHit(
                node.lineno,
                f"`float(...)` on a computed value inside coroutine "
                f"`{fn.name}`: on a device tensor this is a hidden blocking "
                "transfer; fetch at chunk boundaries"))
    return hits


# -- rule: wallclock-in-jit ---------------------------------------------------


def _is_graph_capture(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (any ``....graph(...)`` context)."""
    return (isinstance(node, (ast.With, ast.AsyncWith))
            and any(isinstance(item.context_expr, ast.Call)
                    and _attr_name(item.context_expr.func) == "graph"
                    for item in node.items))


def _check_wallclock_in_jit(tree: ast.AST, src: str) -> List[_RawHit]:
    """A wall-clock read reachable from captured code.

    In the reference, ``time.time()`` inside a traced function ran once
    at trace time and baked a constant into the compiled step.  In the
    port a function under ``torch.compile``, a hot-path contract, or a
    ``with torch.cuda.graph(...)`` capture block is captured the same
    way: a read there, or in a function of the same file it calls (one
    hop deep), is replayed as a constant.  Time on the host side of the
    dispatch boundary instead."""
    fns: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.setdefault(node.name, node)

    def wallclock_hits(root: ast.AST) -> List[_RawHit]:
        out = []
        for node in ast.walk(root):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _WALLCLOCK_ATTRS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("time", "datetime")):
                out.append(_RawHit(
                    node.lineno,
                    f"`time.{node.func.attr}()` reachable from captured code "
                    "(replayed as a capture-time constant); time on the "
                    "host side of the dispatch boundary instead"))
        return out

    def callees(root: ast.AST) -> Iterable[ast.AST]:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and _attr_name(node.func) in fns:
                yield fns[_attr_name(node.func)]

    roots: List[ast.AST] = [
        fn for fn in fns.values()
        if _mentions(fn, {"compile", "hotpath_contract"})]
    roots += [n for n in ast.walk(tree) if _is_graph_capture(n)]
    seen: Set[int] = set()
    hits: List[_RawHit] = []
    for root in roots:
        for node in [root, *callees(root)]:
            if id(node) not in seen:
                seen.add(id(node))
                hits.extend(wallclock_hits(node))
    return hits


def _under(*parts: str) -> Callable[[str], bool]:
    def pred(path: str) -> bool:
        p = path.replace("\\", "/")
        return any(part in p for part in parts)
    return pred


PORT = "src/repro_torch/"

RULES: List[Rule] = [
    Rule("iota-gather", _check_iota_gather.__doc__ or "",
         _under(PORT), _check_iota_gather),
    Rule("eager-scatter", _check_eager_scatter.__doc__ or "",
         _under(PORT + "serving/"), _check_eager_scatter),
    Rule("aliased-donation", _check_aliased_donation.__doc__ or "",
         _under(PORT), _check_aliased_donation),
    Rule("blocking-in-driver", _check_blocking_in_driver.__doc__ or "",
         _under(PORT + "serving/async_server.py",
                PORT + "serving/scheduler.py"),
         _check_blocking_in_driver),
    Rule("wallclock-in-jit", _check_wallclock_in_jit.__doc__ or "",
         _under(PORT), _check_wallclock_in_jit),
]

RULE_NAMES = tuple(r.name for r in RULES)


def _allowed_rules(src_lines: Sequence[str], line: int) -> Set[str]:
    """Pragma rules in force at 1-indexed ``line`` (same line or above)."""
    allowed: Set[str] = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(src_lines):
            m = _PRAGMA_RE.search(src_lines[ln - 1])
            if m:
                allowed.update(s.strip() for s in m.group(1).split(","))
    return allowed


def lint_source(src: str, path: str,
                rules: Optional[Sequence[Rule]] = None) -> List[LintFinding]:
    """Lint one source string as if it lived at ``path``."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, "syntax",
                            f"unparseable: {e.msg}")]
    src_lines = src.splitlines()
    findings = []
    for rule in (RULES if rules is None else rules):
        if not rule.applies_to(path):
            continue
        for hit in rule.check(tree, src):
            if rule.name in _allowed_rules(src_lines, hit.line):
                continue
            findings.append(LintFinding(path, hit.line, rule.name,
                                        hit.message))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths: Iterable[Path],
               root: Optional[Path] = None) -> List[LintFinding]:
    findings = []
    for p in paths:
        rel = p.relative_to(root).as_posix() if root else str(p)
        findings.extend(lint_source(p.read_text(), rel))
    return findings


def repo_files(root: Path) -> List[Path]:
    """The files the port's passes read: every .py under src/repro_torch/."""
    base = root / PORT
    return sorted(base.rglob("*.py")) if base.is_dir() else []


def lint_repo(root: Path = REPO_ROOT) -> List[LintFinding]:
    return lint_paths(repo_files(root), root=root)


def main(argv=None) -> int:
    """The CLI: run the AST rules and/or the concurrency passes over the
    port's files; exit 1 on any finding."""
    from repro_torch.analysis import concurrency

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description=main.__doc__)
    ap.add_argument("--ast", action="store_true",
                    help="run the AST rules")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the guarded-by and await-under-lock passes")
    ap.add_argument("--root", type=Path, default=REPO_ROOT,
                    help="repository root (default: this checkout)")
    ap.add_argument("--report", type=Path, default=None,
                    help="write every finding to this JSON file")
    args = ap.parse_args(argv)
    both = not (args.ast or args.concurrency)
    report: Dict[str, List[str]] = {}
    if args.ast or both:
        report["ast"] = [str(f) for f in lint_repo(args.root)]
    if args.concurrency or both:
        report["concurrency"] = [str(f)
                                 for f in concurrency.check_repo(args.root)]
    for layer, found in report.items():
        name = "AST lint" if layer == "ast" else "concurrency lint"
        for line in found:
            print(line)
        print(f"{name}: {'clean' if not found else f'{len(found)} finding(s)'}")
    if args.report is not None:
        args.report.write_text(json.dumps(report, indent=1))
    return 1 if any(report.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
