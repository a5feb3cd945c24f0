"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU at ``.reduced()`` widths.

- The reference's log lines (``[train] arch=... mesh=... devices=...``,
  ``step N loss L (Ts/step)``, ``[train] resumed from step K``,
  ``[train] done``), finite losses.
- ``--steps 4 --batch 4 --seq 32 --cbtd-gamma 0.5 --cbtd-every 1
  --ckpt-dir DIR``, then the same command with ``--steps 4`` again (it
  resumes at step 4 and takes no step: the restored params, optimizer
  state and data step are ``torch.equal`` to the saved ones), then with
  ``--steps 6``: it resumes at step 4 with data step 4, draws the
  batches an uninterrupted run draws at steps 5 and 6, and prunes at
  alpha = 1 at step 6, after which every subcolumn of every layout leaf
  holds exactly floor(gamma * H / M) zeros (Alg. 1, ``effective_m``).
- Every family trains through the launcher (vlm and audio through
  ``api.make_train_batch``, which still advance the data step).
- Without ``--device cpu`` and without a card it exits naming the flag.
- With several devices visible it trains on their mesh.
"""
import math
import re

import pytest
import torch

from repro_torch import _tree
from repro_torch.core.cbtd import drop_count, effective_m
from repro_torch.data.lm import LMDataset
from repro_torch.launch import train as tlaunch
from repro_torch.models import api
from repro_torch.configs import get_arch

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "4", "--seq", "32",
        "--cbtd-gamma", "0.5", "--cbtd-every", "1", "--log-every", "1",
        "--device", "cpu"]
HEAD = re.compile(r"^\[train\] arch=qwen3-1\.7b mesh=\{'data': 1, "
                  r"'model': 1\} devices=1$")
STEP = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \(\d+\.\d\ds/step\)$")


@pytest.fixture
def drawn(monkeypatch):
    """Every LM batch the launcher draws, by data step."""
    out = {}
    orig = LMDataset.__next__

    def record(self):
        step = self.step
        out.setdefault(step, []).append(orig(self))
        return out[step][-1]

    monkeypatch.setattr(LMDataset, "__next__", record)
    return out


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def _steps(lines):
    return [int(m.group(1)) for m in map(STEP.match, lines) if m]


def _assert_equal_trees(a, b):
    for (path, x), y in zip(_tree.leaves_with_path(a), _tree.leaves(b)):
        assert torch.equal(x, y), path


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys, drawn):
    ckpt = ["--ckpt-dir", str(tmp_path / "run")]
    first = tlaunch.main(ARGS + ckpt + ["--steps", "4"])
    lines = _lines(capsys)
    assert HEAD.match(lines[0]) and lines[-1] == "[train] done"
    assert _steps(lines) == [1, 2, 3, 4] and first.step0 == 0
    assert all(math.isfinite(v) for v in first.losses.values())
    assert first.data.step == 4

    again = tlaunch.main(ARGS + ckpt + ["--steps", "4"])
    lines = _lines(capsys)
    assert "[train] resumed from step 4" in lines and _steps(lines) == []
    assert again.step0 == 4 and again.data.step == 4
    _assert_equal_trees(again.params, first.params)
    _assert_equal_trees(again.opt_state, first.opt_state)

    resumed = tlaunch.main(ARGS + ckpt + ["--steps", "6"])
    lines = _lines(capsys)
    assert "[train] resumed from step 4" in lines
    assert _steps(lines) == [5, 6] and resumed.data.step == 6
    assert int(resumed.opt_state.step) == 6

    tlaunch.main(ARGS + ["--steps", "6", "--ckpt-dir",
                         str(tmp_path / "straight")])
    for step in (4, 5):          # the resumed run's draws, then the other's
        (tok_a, tgt_a), (tok_b, tgt_b) = drawn[step]
        assert torch.equal(tok_a, tok_b) and torch.equal(tgt_a, tgt_b)

    # step 6 pruned at alpha_at(5, 0.2) = 1: Alg. 1's exact balance
    cfg = get_arch("qwen3-1.7b").reduced()
    layout = api.cbtd_layout(cfg)
    n_leaves = 0
    for path, w in _tree.leaves_with_path(resumed.params):
        if not any(pat in path for pat in layout) or w.ndim < 2:
            continue
        h, q = w.shape[-2:]
        m = effective_m(h, 64)
        zeros = (w.reshape(*w.shape[:-2], h // m, m, q) == 0).sum(-3)
        assert bool((zeros == drop_count(h, m, 0.5)).all()), path
        n_leaves += 1
    assert n_leaves == len(layout)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "granite-moe-1b-a400m",
                                  "pixtral-12b", "mamba2-130m",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_every_family_trains_through_the_launcher(name, capsys):
    run = tlaunch.main(["--arch", name, "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0].startswith(f"[train] arch={name} ")
    assert _steps(lines) == [1, 2]
    assert all(math.isfinite(v) for v in run.losses.values())
    assert run.data.step == 2 and int(run.opt_state.step) == 2
    assert all(p.device.type == "cpu" for p in _tree.leaves(run.params))


def test_launcher_refuses_the_host_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA.*--device cpu"):
        tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_launcher_refuses_several_cards(capsys):
    """It no longer refuses several devices: with two visible (two logical
    host devices, ``emulated_devices(2)``) it trains on the (1, 2) mesh,
    its params and optimizer state placed as shards."""
    from repro_torch.distributed.sharding import ShardedTensor
    from repro_torch.launch.mesh import emulated_devices

    with emulated_devices(2):
        run = tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                            "1", "--batch", "2", "--seq", "16", "--log-every",
                            "1", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines[0] == ("[train] arch=qwen3-1.7b mesh={'data': 1, "
                        "'model': 2} devices=2")
    assert _steps(lines) == [1] and math.isfinite(run.losses[1])
    assert all(isinstance(x, ShardedTensor) for x in
               _tree.leaves((run.params, run.opt_state)))
