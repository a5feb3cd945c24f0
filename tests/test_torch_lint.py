"""The port's AST lint rules (repro_torch.analysis.lint) on the CPU.

Each rule of the reference's pass (``tests/test_contracts.py``) flags
its incident, restated in PyTorch's idiom, and passes its clean twin;
the pragma silences the named rule only; the port's own files are clean
under every rule; and the CLI runs.

    PYTHONPATH=src python -m pytest -q tests/test_torch_lint.py
"""
import json
import textwrap

from repro_torch.analysis import lint


def _lint(src, path="src/repro_torch/serving/fake.py"):
    return lint.lint_source(textwrap.dedent(src), path)


def test_rule_iota_gather_flags_and_twin_passes():
    bad = _lint("""
        import torch
        def gather(frames, cursor):
            return frames[torch.arange(frames.shape[0]), cursor]
    """)
    assert [f.rule for f in bad] == ["iota-gather"]
    good = _lint("""
        import torch
        def gather(frames, cursor):
            idx = cursor.long()[:, None, None].expand(-1, 1, frames.shape[2])
            return torch.gather(frames, 1, idx)[:, 0]
    """)
    assert good == []


def test_rule_iota_gather_applies_across_the_port():
    """The rule reads every file of the port, not only serving/."""
    src = """
        import torch
        def pick(x, i):
            return x[torch.arange(x.shape[0]), i]
    """
    assert [f.rule for f in _lint(src, "src/repro_torch/kernels/f.py")] == [
        "iota-gather"]
    assert _lint(src, "src/repro/kernels/f.py") == []


def test_rule_eager_scatter_flags_and_twin_passes():
    bad = _lint("""
        def host_side(buf, idx, rows, mask, src):
            a = buf.index_copy(0, idx, rows)
            b = buf.scatter(0, idx, rows)
            c = buf.index_put((idx,), rows)
            d = buf.masked_scatter(mask, src)
            return a, b, c, d
    """)
    assert [f.rule for f in bad] == ["eager-scatter"] * 4
    # the in-place forms write only the rows they name:
    assert _lint("""
        def host_side(buf, idx, rows, mask, src):
            buf.index_copy_(0, idx, rows)
            buf.scatter_(0, idx, rows)
            buf.index_put_((idx,), rows)
            buf.masked_scatter_(mask, src)
    """) == []
    # outside serving/, out of scope for this rule:
    assert _lint("""
        def host_side(buf, idx, rows):
            return buf.index_copy(0, idx, rows)
    """, path="src/repro_torch/models/fake.py") == []


def test_rule_aliased_donation_flags_and_twin_passes():
    bad = _lint("""
        import torch
        def init(n):
            z = torch.zeros((n,))
            return State(z, z, z)
    """)
    assert {f.rule for f in bad} == {"aliased-donation"}
    good = _lint("""
        import torch
        def init(n):
            def z():
                return torch.zeros((n,))
            return State(z(), z(), z())
    """)
    assert good == []


def test_rule_blocking_in_driver_flags_and_twin_passes():
    path = "src/repro_torch/serving/async_server.py"
    bad = _lint("""
        import torch
        async def pump(out):
            a = out.item()
            b = out.cpu()
            c = out.tolist()
            d = out.numpy()
            torch.cuda.synchronize()
            x = float(out[0])
            return a, b, c, d, x
    """, path)
    assert [f.rule for f in bad] == ["blocking-in-driver"] * 6
    good = _lint("""
        async def pump(loop, out):
            val = await loop.run_in_executor(None, _fetch, out)
            return val
        def _fetch(out):
            return out.cpu().numpy()   # sync helper, off the event loop
    """, path)
    assert good == []
    # the scheduler is in scope too; a launcher is not:
    src = """
        async def pump(out):
            return out.numpy()
    """
    assert len(_lint(src, "src/repro_torch/serving/scheduler.py")) == 1
    assert _lint(src, "src/repro_torch/launch/fake.py") == []


def test_rule_wallclock_in_jit_flags_and_twin_passes():
    bad = _lint("""
        import time, torch
        def _inner(x):
            return x * time.time()
        @torch.compile
        def step(x):
            return _inner(x)
    """)
    assert [f.rule for f in bad] == ["wallclock-in-jit"]
    good = _lint("""
        import time, torch
        @torch.compile(mode="reduce-overhead")
        def step(x):
            return x * 2.0
        def drive(x):
            t0 = time.time()      # host side: fine
            return step(x), time.time() - t0
    """)
    assert good == []


def test_rule_wallclock_in_jit_covers_graph_capture_and_contracts():
    """A CUDA-graph capture block and a hot-path contract are captured
    code too; the rule follows one call hop, not two."""
    capture = _lint("""
        import time, torch
        def _stamp(x):
            return x + time.perf_counter()
        def capture(g, x):
            with torch.cuda.graph(g):
                y = _stamp(x)
            return y
    """)
    assert [f.rule for f in capture] == ["wallclock-in-jit"]
    contract = _lint("""
        import time
        @hotpath_contract("step_chunk")
        def step_chunk(x):
            return x * time.monotonic()
    """)
    assert [f.rule for f in contract] == ["wallclock-in-jit"]
    assert _lint("""
        import time, torch
        def _deep(x):
            return x * time.time()
        def _mid(x):
            return _deep(x)
        @torch.compile
        def step(x):
            return _mid(x)
    """) == []


def test_pragma_escape_suppresses_named_rule_only():
    src = """
        def host_side(buf, idx, rows):
            # lint: allow(eager-scatter) one-off restore, off the hot path
            return buf.index_copy(0, idx, rows)
    """
    assert _lint(src) == []
    wrong_rule = """
        def host_side(buf, idx, rows):
            # lint: allow(iota-gather)
            return buf.index_copy(0, idx, rows)
    """
    assert [f.rule for f in _lint(wrong_rule)] == ["eager-scatter"]


def test_port_is_lint_clean():
    files = lint.repo_files(lint.REPO_ROOT)
    assert any(p.name == "scheduler.py" for p in files)
    assert all("repro_torch" in p.parts for p in files)
    findings = lint.lint_repo()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lint_cli(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert lint.main(["--ast", "--report", str(report)]) == 0
    assert "AST lint: clean" in capsys.readouterr().out
    assert json.loads(report.read_text()) == {"ast": []}
    # a tree with a finding exits 1 and prints it
    bad = tmp_path / "src" / "repro_torch" / "serving"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("def f(b, i, r):\n    return b.scatter(0, i, r)\n")
    assert lint.main(["--ast", "--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "src/repro_torch/serving/x.py:2: [eager-scatter]" in out
    assert "AST lint: 1 finding(s)" in out
