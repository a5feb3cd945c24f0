"""Model families (``bench/families/``): the DeltaLSTM family's counts
from shapes and its weights pinned to the values the harness had before
families existed, and a second family that exists only as new files
runs through a cell end to end."""
import hashlib
import json
import textwrap

import pytest
import torch

from bench import cell, counting
from bench.families import delta_lstm
from bench.program import import_port
from bench.tests.conftest import ROOT, tiny_config

import_port()


def test_kept_weights_per_column():
    # 4H = 4096 rows in M = 64 subcolumns of S = 64: CBTD drops
    # floor(64 * 0.9375) = 60 of each, keeps 4 -> 256 = 4H (1 - gamma)
    assert counting.kept_per_column(4096, 0.9375, 64) == 256
    assert counting.kept_per_column(2048, 0.9375, 64) == 128
    cfg = {"input_dim": 123, "hidden_dim": 1024, "gamma": 0.9375, "m": 64}
    assert delta_lstm.ops_per_fired(cfg) == {123: 512, 1024: 512}
    # S = 24/M = 6, floor(6 * 0.75) = 4 dropped, 2 kept a subcolumn
    assert counting.kept_per_column(24, 0.75, 4) == 8


def test_row_ops_from_shapes():
    cfg = {"input_dim": 3, "hidden_dim": 2, "n_classes": 5, "n_layers": 2}
    layer1 = 2 * (3 + 2) + 4 * 2 + 9 * 2
    layer2 = 2 * (2 + 2) + 4 * 2 + 9 * 2
    head = 2 * 2 * 2 + 2 + 2 * 2 * 5 + 5
    assert delta_lstm.row_ops(cfg) == layer1 + layer2 + head


def params_digest(params) -> str:
    h = hashlib.sha256()
    for lp in params["lstm"]:
        for k in ("w_x", "w_h", "b"):
            h.update(lp[k].numpy().tobytes())
    for group in ("fcl", "logit"):
        for k in ("w", "b"):
            h.update(params[group][k].numpy().tobytes())
    return h.hexdigest()


TINY = {"tiny": {}, "tinyq": dict(n_layers=3, quant=True,
                                  spmv_path="scatter", precision="int8")}
# sha256 of make_params' tensors on the CPU, as the harness made them
# before the family key (bench/weights.py's make_params)
GOLDEN_PARAMS = {
    ("tiny", 7):
        "5b2f66f579a5d6a10f357c2bb5bd565164e224d91119893714e30f11e00debbf",
    ("tiny", 2 ** 31 + 12345):
        "424c740717774e9d1b81985502269bce751392b467abbcbb262562060d164206",
    ("tinyq", 7):
        "a732f8ea9fa2ee4ee53cbc3b620d2fa6b35f5fef62961f3d3e85cfad1ddf3da4",
    ("tinyq", 2 ** 31 + 12345):
        "47f6bc256ee8bcc96ff4ec37c6c0fed9367e25656265237c6b967a26e1f35123",
}
# (row_ops, operations per fired delta) as counting.py gave them then
GOLDEN_COUNTS = {"tiny": (5799, 64), "tinyq": (6343, 64),
                 "dlstm-2l1024h": (2215199, 512),
                 "dlstm-3l512h-int8": (592159, 256)}


@pytest.mark.parametrize("name,seed", sorted(GOLDEN_PARAMS))
def test_delta_lstm_weights_are_the_harness_s_before(name, seed):
    cfg = tiny_config(name, **TINY[name])
    params = delta_lstm.make_params(cfg, seed, torch.device("cpu"))
    assert params_digest(params) == GOLDEN_PARAMS[(name, seed)]


@pytest.mark.parametrize("name", sorted(GOLDEN_COUNTS))
def test_delta_lstm_counts_are_the_harness_s_before(name):
    if name in TINY:
        cfg = tiny_config(name, **TINY[name])
    else:
        cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
        assert cfg["family"] == "delta_lstm"
    row_ops, per_fired = GOLDEN_COUNTS[name]
    assert delta_lstm.row_ops(cfg) == row_ops
    widths = {cfg["input_dim"], cfg["hidden_dim"]}
    assert delta_lstm.ops_per_fired(cfg) == dict.fromkeys(widths, per_fired)
    assert delta_lstm.row_width(cfg) == delta_lstm.input_dim(cfg) == \
        cfg["input_dim"]


# A second family, written by the test under the data root alone: normal
# weights instead of uniform ones, and a per-width cost of its own.
TOY_FAMILY = '''
"""Toy family: a DeltaLSTM with normal weights, for the harness's tests."""
import math

import torch

from bench.counting import kept_per_column
from bench.weights import cbtd_keep_mask

PORT_MODULE = "repro_torch.models.lstm_am"
PORT_CONFIG = "LSTMAMConfig"
TOY_MARK = 7.0


def model_kwargs(cfg):
    return dict(input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                n_layers=cfg["n_layers"], n_classes=cfg["n_classes"],
                delta=True, theta=cfg["theta"])


def input_dim(cfg):
    return cfg["input_dim"]


def row_width(cfg):
    return cfg["input_dim"]


def ops_per_fired(cfg):
    kept = kept_per_column(4 * cfg["hidden_dim"], cfg["gamma"], cfg["m"])
    return {cfg["input_dim"]: 2 * kept, cfg["hidden_dim"]: 3 * kept}


def row_ops(cfg):
    return 1


def make_params(cfg, seed, device):
    d, h, c = cfg["input_dim"], cfg["hidden_dim"], cfg["n_classes"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    normal = lambda *s: torch.randn(s, generator=gen, device=device)
    lstm, d_in = [], d
    for _ in range(cfg["n_layers"]):
        w = normal(4 * h, d_in + h) * (0.5 / math.sqrt(h))
        w = w * cbtd_keep_mask(w, cfg["gamma"], cfg["m"]) / (1 - cfg["gamma"])
        b = torch.zeros((4, h), device=device)
        b[2] = 1.0
        lstm.append({"w_x": w[:, :d_in].contiguous(),
                     "w_h": w[:, d_in:].contiguous(), "b": b})
        d_in = h
    return {"lstm": lstm,
            "fcl": {"w": normal(h, h) / math.sqrt(h),
                    "b": torch.zeros(h, device=device)},
            "logit": {"w": normal(c, h) / math.sqrt(h),
                      "b": torch.zeros(c, device=device)}}
'''

TOY_METRIC = '''
def read(rec):
    return rec["family"].TOY_MARK
'''

# the toy reference is the DeltaLSTM reference, leaving a mark when run
TOY_REFERENCE_TAIL = '''

_plain_forward = forward


def forward(*args, **kw):
    from pathlib import Path

    Path(__file__).with_suffix(".ran").touch()
    return _plain_forward(*args, **kw)
'''


def test_a_family_of_new_files_runs_through_a_cell(tiny_root):
    bench = tiny_root / "bench"
    (bench / "families" / "toy_lstm.py").write_text(
        textwrap.dedent(TOY_FAMILY))
    (bench / "reference" / "toy_ref.py").write_text(
        (ROOT / "bench/reference/delta_lstm.py").read_text()
        + TOY_REFERENCE_TAIL)
    (bench / "metrics" / "toy.mark.py").write_text(TOY_METRIC)
    (bench / "configs" / "toy.json").write_text(json.dumps(
        tiny_config("toy", family="toy_lstm", reference="toy_ref")))
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy", "source": "tiny", "reduced": [],
                           "file": "bench/configs/toy.json", "why": "x"})
    man["workloads"].append({"name": "toy.bulk", "config": "toy",
                             "traffic": "bulk", "chips": 1, "why": "x"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("frames_per_s", "step.mfu"):
            m["workloads"].append("toy.bulk")
    man["per_layer"].append({"name": "toy.mark", "unit": "x",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "frames_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert not (ROOT / "bench/families/toy_lstm.py").exists()

    out = cell.run(tiny_root, "toy.bulk", 2 ** 31 + 99, 1.0, True, "cpu")
    res = out["result"]
    assert res["correct"], res["compared"]
    assert (bench / "reference" / "toy_ref.ran").exists()
    assert res["metrics"]["toy.mark"]["value"] == 7.0
    assert res["metrics"]["step.mfu"]["value"] > 0
    res = cell.run(tiny_root, "toy.bulk", 5, 1.0, False, "cpu")["result"]
    assert res["correct"] and set(res["metrics"]) == {"frames_per_s",
                                                      "setup_s"}
