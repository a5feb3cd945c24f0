"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest -q bench/tests``; ``-m gpu`` on a card).

``tiny_root`` is a data root beside the real one: ``BENCHMARK.json``
with the parked cells (``bench/parked.json``) added, the configuration
and traffic files cut to sizes a CPU runs in seconds, with the real
cells' names, and the metric readers, model families and references."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tiny_config(name: str, **kw) -> dict:
    cfg = json.loads((ROOT / "bench/configs/dlstm-2l1024h.json").read_text())
    cfg.update(name=name, input_dim=15, hidden_dim=32, fc_dim=32,
               n_layers=2, m=8, gamma=0.75)
    cfg.update(kw)
    return cfg


def make_tiny_root(path: Path) -> Path:
    bench = path / "bench"
    for kind in ("metrics", "families", "reference"):
        shutil.copytree(ROOT / "bench" / kind, bench / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    configs = {"tiny": tiny_config("tiny"),
               "tinyq": tiny_config("tinyq", n_layers=3, quant=True,
                                    spmv_path="scatter",
                                    precision="int8")}
    for name, cfg in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name in ("bulk", "noise-bulk", "stream", "batch1"):
        t = json.loads((ROOT / f"bench/traffic/{name}.json").read_text())
        if t["features"]["kind"] == "speech":
            t["features"]["n_static"] = 5
        t["lengths"] = {"median": 40, "sigma": 0.4, "min": 12, "max": 100}
        if name.endswith("bulk"):
            t.update(clients=8, utterances=32, warmup_s=0.3)
            t["server"].update(capacity=4, max_frames=128)
        if name == "stream":
            t.update(rate_per_s=20, ramp_s=0.3)
            t["server"].update(capacity=16, max_frames=128)
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    parked = json.loads((ROOT / "bench" / "parked.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        man[key] += parked[key]
    man["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                       "file": f"bench/configs/{n}.json", "why": "tests"}
                      for n in configs]
    for w in man["workloads"]:
        w["config"] = "tinyq" if "int8" in w["config"] else "tiny"
    (path / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
