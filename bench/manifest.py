"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the JSON file its entry names; a traffic mix is
``bench/traffic/<traffic>.json``; a metric is read by
``bench/metrics/<metric>.py``, a module with ``read(rec) -> float | None``.
A configuration names its model family, ``bench/families/<family>.py``
(``bench/families/__init__.py`` says what one provides), and its plain
reference, ``bench/reference/<reference>.py``.  All are found under the
root the manifest was read from.  A later cell, mix, metric or family is
new files and new entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = "bench"


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[Tuple[str, str], ModuleType] = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.root / BENCH_DIR / "traffic" / f"{name}.json"
        return json.loads(path.read_text())

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        untraced, its per-layer ones traced.  A per-layer metric without a
        ``workloads`` key goes with every cell that reports its ``moves``."""
        e2e = [m for m in self.data["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])
                and m["moves"] in names]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return self._module("metrics", metric).read

    def family(self, name: str) -> ModuleType:
        return self._module("families", name)

    def reference(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def _module(self, kind: str, name: str) -> ModuleType:
        mod = self._modules.get((kind, name))
        if mod is None:
            path = self.root / BENCH_DIR / kind / f"{name}.py"
            tag = name.replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(
                f"bench_{kind}_{tag}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[(kind, name)] = mod
        return mod
