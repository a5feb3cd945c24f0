"""Analysis for the serving hot paths — port of ``repro/analysis``.

* ``contracts``/``cases``/``hlo`` — contract checking: each hot-path
  function declares its invariants with ``@hotpath_contract``;
  ``ContractCase``s run it once on representative arguments under an
  aten-op trace, and the checker asserts the trace (no collectives, no
  host transfers, donation honoured in place, a float32 ceiling, op
  budgets).
* ``lockorder`` — the runtime lock-order recorder and lock factory.

The reference's static passes (``lint`` and ``concurrency``) are not
copied: they read every ``.py`` under ``src/``, the port's included.

    PYTHONPATH=src python -m pytest -q tests/test_torch_contracts.py
"""
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
]
