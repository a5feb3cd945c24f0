"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro``, and its entry points refuse to run on the host when
they were asked for the card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch._device import resolve_device
from repro_torch.models import lstm_am
from repro_torch.serving import (
    BatchedSpartusEngine,
    EngineConfig,
    SpartusEngine,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "repro")))
print(len(names), leaked)
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, leaked = proc.stdout.split(" ", 1)
    assert int(n) >= 15 and leaked.strip() == "[]", proc.stdout


#: the last slice's modules, the counterparts of the reference's last
#: unported files; the walk above imports them with the rest
LAST_SLICE = ("distributed/hints.py", "distributed/compression.py",
              "launch/dryrun.py", "launch/roofline.py",
              "launch/hillclimb.py", "launch/summarize.py")


@pytest.mark.parametrize("rel", LAST_SLICE)
def test_last_slice_modules_exist_beside_their_references(rel):
    assert (PORT / rel).is_file() and (REPO / "src" / "repro" / rel).is_file()
    assert not _jax_imports(PORT / rel)


def test_the_port_covers_every_reference_module():
    ref = REPO / "src" / "repro"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if not (PORT / p.relative_to(ref)).is_file()]
    assert missing == []


def _jax_imports(path):
    tree = ast.parse(path.read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        found += [(node.lineno, r) for r in roots
                  if r in ("jax", "jaxlib", "repro")]
    return found


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_names_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro"} & set(roots), (
            f"{path.name}:{node.lineno} imports {roots}")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_never_falls_back(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("engine_cls", [SpartusEngine, BatchedSpartusEngine])
def test_engines_raise_without_a_card(no_cuda, engine_cls):
    cfg = lstm_am.LSTMAMConfig(input_dim=6, hidden_dim=8, n_layers=1,
                               n_classes=3)
    params = lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_cls(params, cfg, EngineConfig(m=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        lstm_am.init_params(torch.Generator().manual_seed(0), cfg)
    assert engine_cls(params, cfg, EngineConfig(m=4),
                      device="cpu").device.type == "cpu"


def test_async_server_and_pool_run_only_where_asked(no_cuda):
    """AsyncSpartusServer has no device of its own: it serves on its
    engine's, which defaults to the card and refuses to build without
    one; given an engine on the CPU it serves there."""
    import asyncio

    import numpy as np

    from repro_torch.serving import AsyncSpartusServer

    cfg = lstm_am.LSTMAMConfig(input_dim=6, hidden_dim=8, n_layers=1,
                               n_classes=3)
    params = lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncSpartusServer(BatchedSpartusEngine(params, cfg,
                                                EngineConfig(m=4)), 2)
    engine = BatchedSpartusEngine(params, cfg, EngineConfig(m=4),
                                  device="cpu")

    async def run():
        async with AsyncSpartusServer(engine, 2, chunk_frames=4) as srv:
            return await srv.submit(np.ones((5, 6), np.float32))

    assert asyncio.run(run()).logits.shape == (5, 3)


def test_launcher_exits_naming_the_missing_card():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--spartus",
         "--async", "--hidden", "8", "--clients", "1"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--device cpu" in proc.stderr
    assert "served" not in proc.stdout


def test_model_zoo_entry_points_refuse_the_host_unless_asked(no_cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as tlaunch
    from repro_torch.models import api

    cfg = get_arch("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 8)
    assert api.init_cache(cfg, 1, 8, device="cpu")["pos"].device.type == "cpu"
    with pytest.raises(SystemExit, match="CUDA.*--device cpu"):
        tlaunch.main(["--arch", "qwen2-0.5b", "--batch", "1", "--steps", "1"])
