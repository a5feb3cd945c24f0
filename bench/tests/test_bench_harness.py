"""The harness end to end on the CPU at tiny sizes (the look for a card
skipped): every cell runs and is correct; a configuration, a mix and a
metric added as files and entries are picked up; and with the timed
path broken underneath, ``correct`` comes out false."""
import json
import subprocess
import sys

import pytest
import torch

from bench import cell
from bench.program import import_port
from bench.tests.conftest import ROOT, tiny_config

import_port()

CELLS = ["dlstm-2l1024h.bulk", "dlstm-3l512h-int8.bulk",
         "dlstm-2l1024h.noise-bulk", "dlstm-2l1024h.stream",
         "dlstm-2l1024h.batch1"]
SEED = 2 ** 31 + 12345


def run(root, workload, trace=False, seconds=1.0):
    return cell.run(root, workload, SEED, seconds, trace, "cpu")["result"]


@pytest.mark.parametrize("workload", CELLS)
def test_cells_run_and_are_correct(tiny_root, workload):
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for trace in (False, True):
        res = run(tiny_root, workload, trace)
        assert res["correct"], res["compared"]
        assert list(res)[-1] == "compared"
        assert res["attempted"] > 0 and res["failed"] == 0
        names = set(res["metrics"])
        if not trace:
            want = {m["name"] for m in man["end_to_end"]
                    if workload in m.get("workloads", [workload])}
            assert names == want
        else:
            # the device's metrics need the card; the rest are read here
            spans = {m["name"] for m in man["per_layer"]
                     if workload in m["workloads"]
                     and m["source"] in ("program_span", "program_counter")}
            assert spans <= names


def test_a_new_config_mix_and_metric_are_found_by_name(tiny_root):
    bench = tiny_root / "bench"
    (bench / "configs" / "dummy.json").write_text(json.dumps(
        tiny_config("dummy", hidden_dim=16, fc_dim=16)))
    mix = json.loads((bench / "traffic" / "bulk.json").read_text())
    mix.update(clients=3, features={"kind": "noise", "scale": 1.0})
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy.rows.py").write_text(
        "def read(rec):\n"
        "    return float(sum(n for _, n in rec['deliveries']))\n")
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy", "source": "tiny", "reduced": [],
                           "file": "bench/configs/dummy.json", "why": "x"})
    man["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy",
                             "traffic": "dummy-mix", "chips": 1,
                             "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dummy.dummy-mix")
    man["per_layer"].append({"name": "dummy.rows", "unit": "rows",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "frames_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    res = run(tiny_root, "dummy.dummy-mix", trace=True)
    assert res["correct"]
    assert res["metrics"]["dummy.rows"]["value"] > 0
    res = run(tiny_root, "dummy.dummy-mix")
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_a_forbidden_module_loaded_by_a_reader_refuses_the_run(
        tiny_root, capsys, monkeypatch, name):
    """A metric's reader runs after the window and after the comparison;
    a JAX-side module it loads still keeps the result from printing.
    What other tests in this process loaded of JAX or the JAX package is
    out of ``sys.modules`` for the test's length (monkeypatch puts it
    back), so the run sees only what the reader loads."""
    from bench import run as bench_run

    for loaded in cell.loaded_forbidden(list(sys.modules)):
        monkeypatch.delitem(sys.modules, loaded, raising=False)

    (tiny_root / "bench" / "metrics" / "planted.py").write_text(
        "import sys, types\n"
        "def read(rec):\n"
        f"    sys.modules[{name!r}] = types.ModuleType({name!r})\n"
        "    return 1.0\n")
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "planted", "unit": "x",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "frames_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert name not in sys.modules
    try:
        out = cell.run(tiny_root, CELLS[0], SEED, 1.0, True, "cpu")
        assert "planted" in out["result"]["metrics"]
        capsys.readouterr()
        assert bench_run.report(out) == 3
        got = capsys.readouterr()
        assert got.out == ""
        assert got.err == f"loaded in this process: {name}\n"
    finally:
        sys.modules.pop(name, None)
    assert bench_run.report(out) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]


def _state_unchanged(monkeypatch):
    """The HPE stage returns h but leaves c, h and dm as they were."""
    from repro_torch.kernels import ops

    orig = ops.lstm_pointwise_step

    def stale(dm, y, c, h, *, active=None):
        saved = [t.clone() for t in (dm, c, h)]
        out = orig(dm, y, c, h, active=active)
        for t, s in zip((dm, c, h), saved):
            t.copy_(s)
        return out

    monkeypatch.setattr(ops, "lstm_pointwise_step", stale)


def _half_batch_left_out(monkeypatch):
    """The gate products of the upper half of the slots are dropped."""
    from repro_torch.kernels import ops

    orig = ops.lstm_pointwise_step

    def half(dm, y, c, h, *, active=None):
        y = y.clone()
        y[(y.shape[0] + 1) // 2:] = 0
        return orig(dm, y, c, h, active=active)

    monkeypatch.setattr(ops, "lstm_pointwise_step", half)


def _answer_altered(monkeypatch):
    """One logit of every row is nudged where the head produces it."""
    from repro_torch.serving.engine import PackedSpartusModel

    orig = PackedSpartusModel.head

    def head(self, h):
        out = orig(self, h).clone()
        out[..., 3] += 1e-3
        return out

    monkeypatch.setattr(PackedSpartusModel, "head", head)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_batch_left_out": _half_batch_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload,
                                          fault):
    if fault == "half_batch_left_out" and workload.endswith("batch1"):
        pytest.skip("a batch of one has no half to leave out")
    FAULTS[fault](monkeypatch)
    res = run(tiny_root, workload)
    assert not res["correct"], res["compared"]


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench/run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    # a directory holding only BENCHMARK.json and the benchmark's files
    bare = tmp_path / "bare"
    bare.mkdir()
    subprocess.run(["cp", "-r", str(ROOT / "bench"), str(bare)], check=True)
    (bare / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=bare, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
