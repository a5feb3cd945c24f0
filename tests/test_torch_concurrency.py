"""The port's concurrency passes (repro_torch.analysis.concurrency) on
the CPU: the static guarded-by/lockset pass and the await-under-lock
rule, through the cases of the reference's ``tests/test_concurrency.py``
with the port's paths; the port's tree is clean, and stripping the lock
from the port's scheduler trips the pass.

    PYTHONPATH=src python -m pytest -q tests/test_torch_concurrency.py
"""
import json
import textwrap
from pathlib import Path

from repro_torch.analysis import concurrency, lint

REPO_ROOT = Path(__file__).resolve().parent.parent
SCHEDULER = REPO_ROOT / "src" / "repro_torch" / "serving" / "scheduler.py"


def _check(src: str, path: str = "src/repro_torch/serving/fake.py"):
    return concurrency.check_source(textwrap.dedent(src), path)


# ------------------------------------------------ guarded-by: rule basics


def test_unguarded_read_and_write_flagged():
    findings = _check("""
        class P:
            _guarded_by_ = {"state": "_lk", "_out": "_lk"}
            def __init__(self):
                self.state = 0
            def read(self):
                return self.state
            def write(self):
                self._out = 1
    """)
    assert [f.rule for f in findings] == ["guarded-by", "guarded-by"]
    assert "read of `self.state`" in findings[0].message
    assert "write to `self._out`" in findings[1].message


def test_guarded_twin_is_clean():
    assert _check("""
        class P:
            _guarded_by_ = {"state": "_lk", "_out": "_lk"}
            def read(self):
                with self._lk:
                    return self.state
            def write(self):
                with self._lk:
                    self._out = 1
    """) == []


def test_multi_item_with_counts():
    """``with self._tracer.span(...), self._lk:`` — the scheduler's
    dispatch shape — must register the lock."""
    assert _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def step(self):
                with self.tracer.span("dispatch"), self._lk:
                    self.state = self.f(self.state)
    """) == []


def test_init_is_exempt():
    assert _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def __init__(self):
                self.state = 0
    """) == []


def test_unrelated_lock_does_not_count():
    findings = _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def read(self):
                with self._other:
                    return self.state
    """)
    assert [f.rule for f in findings] == ["guarded-by"]


def test_undeclared_class_is_ignored():
    assert _check("""
        class P:
            def read(self):
                return self.state
    """) == []


def test_malformed_guard_table_flagged():
    findings = _check("""
        class P:
            _guarded_by_ = {"state": LOCK}
            def read(self):
                return self.state
    """)
    assert len(findings) == 1
    assert "literal" in findings[0].message


# ------------------------------------- guarded-by: one-hop call resolution


def test_helper_with_all_callsites_locked_is_clean():
    assert _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def _helper(self):
                return self.state
            def caller(self):
                with self._lk:
                    return self._helper()
            def caller2(self):
                with self._lk:
                    if self.flag:
                        return self._helper()
    """) == []


def test_helper_with_one_unlocked_callsite_flagged():
    findings = _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def _helper(self):
                return self.state
            def caller(self):
                with self._lk:
                    return self._helper()
            def rogue(self):
                return self._helper()
    """)
    assert [f.rule for f in findings] == ["guarded-by"]
    assert "_helper" in findings[0].message


def test_resolution_is_one_hop_not_transitive():
    """A two-hop chain (locked caller -> mid -> helper) is NOT resolved:
    shallow on purpose, like the wallclock-in-jit rule."""
    findings = _check("""
        class P:
            _guarded_by_ = {"state": "_lk"}
            def _helper(self):
                return self.state
            def _mid(self):
                return self._helper()
            def caller(self):
                with self._lk:
                    return self._mid()
    """)
    assert [f.rule for f in findings] == ["guarded-by"]


# ------------------------------------------------ guarded-by: pragma escape


def test_pragma_suppresses_named_rule_only():
    src = """
        class P:
            _guarded_by_ = {"state": "_lk"}
            def audited(self):
                return self.state  # lint: allow(guarded-by) tick-thread-only
            def rogue(self):
                return self.state  # lint: allow(eager-scatter)
    """
    findings = _check(src)
    assert len(findings) == 1
    assert "rogue" in findings[0].message


# --------------------------------------------------------- await-under-lock


def test_await_under_lock_flagged_and_twin_clean():
    bad = _check("""
        class S:
            async def pump(self):
                with self._state_lock:
                    await self.q.get()
    """, path="src/repro_torch/serving/async_server.py")
    assert [f.rule for f in bad] == ["await-under-lock"]
    good = _check("""
        class S:
            async def pump(self):
                with self._state_lock:
                    q = self.q
                await q.get()
    """, path="src/repro_torch/serving/async_server.py")
    assert good == []


def test_await_under_lock_scoped_to_serving():
    src = """
        class S:
            async def pump(self):
                with self._lock:
                    await self.q.get()
    """
    assert _check(src, path="src/repro_torch/training/x.py") == []
    assert len(_check(src, path="src/repro_torch/serving/x.py")) == 1


# ------------------------------------------- port-clean + acceptance (static)


def test_port_is_concurrency_clean():
    findings = concurrency.check_repo()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_scope_is_the_port():
    """The reference's own paths are out of scope (its pass covers
    them), the port's everywhere in it."""
    src = """
        class P:
            _guarded_by_ = {"state": "_lk"}
            def read(self):
                return self.state
    """
    assert _check(src, path="src/repro/serving/x.py") == []
    assert len(_check(src, path="src/repro_torch/models/x.py")) == 1


def test_acceptance_mutation_lock_stripped_measured_sparsity():
    """Strip the lock from the port's ``measured_sparsity`` (the
    reference's race site: a scrape reading the state while a tick
    rebinds it) and the checker must fire on the now-unguarded
    ``self._shards`` read."""
    src = SCHEDULER.read_text()
    guarded = ("        with self._state_lock:\n"
               "            host = [t.detach().cpu().numpy() for sh in "
               "self._shards")
    assert guarded in src, "measured_sparsity lock site moved; update test"
    mutated = src.replace(guarded, guarded.replace(
        "with self._state_lock:", "if True:"))
    rel = SCHEDULER.relative_to(REPO_ROOT).as_posix()
    assert concurrency.check_source(src, rel) == []
    findings = concurrency.check_source(mutated, rel)
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "guarded-by"
    assert "measured_sparsity" in f.message and "self._shards" in f.message


def test_lint_cli_concurrency(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert lint.main(["--concurrency", "--report", str(report)]) == 0
    assert "concurrency lint: clean" in capsys.readouterr().out
    assert json.loads(report.read_text())["concurrency"] == []
