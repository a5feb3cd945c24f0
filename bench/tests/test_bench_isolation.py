"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
comparing top-level names whole; the reference imports nothing of the
port; and the run refuses a process that loaded either."""
import ast
from pathlib import Path

import pytest

from bench import cell
from bench.tests.conftest import ROOT

BENCH = ROOT / "bench"
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_side_imports(path):
    assert not set(imported_tops(path)) & JAX_SIDE


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = set(imported_tops(path))
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "typing", "torch", "numpy", "math"}, \
            (path, tops)


def test_only_program_imports_the_port():
    users = {p.relative_to(BENCH).as_posix() for p in SOURCES
             if "repro_torch" in set(imported_tops(p))
             and p.parent.name != "tests"}
    assert users == {"program.py"}


def test_forbidden_modules_are_matched_whole():
    mods = ["repro_torch", "repro_torch.serving", "reprox", "numpy",
            "jaxtyping", "repro", "repro.kernels", "jax.numpy", "flax"]
    assert cell.loaded_forbidden(mods) == ["flax", "jax.numpy", "repro",
                                           "repro.kernels"]
