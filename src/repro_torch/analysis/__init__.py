"""Analysis for the serving hot paths — port of ``repro/analysis``.

* ``contracts``/``cases``/``hlo`` — contract checking: each hot-path
  function declares its invariants with ``@hotpath_contract``;
  ``ContractCase``s run it once on representative arguments under an
  aten-op trace, and the checker asserts the trace (no collectives, no
  host transfers, donation honoured in place, a float32 ceiling, op
  budgets).
* ``lint`` — the reference's AST rules in PyTorch's idiom
  (iota-gather, eager-scatter, aliased-donation, blocking-in-driver,
  wallclock-in-jit) over ``src/repro_torch/``.
* ``concurrency``/``lockorder`` — the static guarded-by and
  await-under-lock passes over the same files, and the runtime
  lock-order recorder and lock factory.

    PYTHONPATH=src python -m pytest -q tests/test_torch_contracts.py
    PYTHONPATH=src python -m repro_torch.analysis.lint [--concurrency]

The names of ``lint`` and ``concurrency`` load on first use, so that
``python -m repro_torch.analysis.lint`` runs the module it imports.
"""
import importlib
from repro_torch.analysis import hlo  # noqa: F401
from repro_torch.analysis.contracts import (  # noqa: F401
    ContractReport,
    HotpathContract,
    Violation,
    check_built,
    check_case,
    check_trace,
    get_contract,
    hotpath_contract,
    registered_contracts,
)
from repro_torch.analysis.lockorder import (  # noqa: F401
    InstrumentedLock,
    LockOrderRecorder,
    make_lock,
)

_LAZY = {
    "LintFinding": ("lint", "LintFinding"),
    "RULES": ("lint", "RULES"),
    "RULE_NAMES": ("lint", "RULE_NAMES"),
    "lint_repo": ("lint", "lint_repo"),
    "lint_source": ("lint", "lint_source"),
    "CONCURRENCY_RULE_NAMES": ("concurrency", "CONCURRENCY_RULE_NAMES"),
    "check_concurrency_repo": ("concurrency", "check_repo"),
    "check_concurrency_source": ("concurrency", "check_source"),
}


def __getattr__(name):
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ContractReport",
    "HotpathContract",
    "Violation",
    "check_built",
    "check_case",
    "check_trace",
    "get_contract",
    "hotpath_contract",
    "registered_contracts",
    "InstrumentedLock",
    "LockOrderRecorder",
    "make_lock",
    "hlo",
    *_LAZY,
]
