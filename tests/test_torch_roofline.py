"""The port's dry-run tooling on the CPU (``repro_torch.launch.{roofline,
dryrun,hillclimb,summarize}``, ``repro_torch.models.api.input_specs``)
against the reference.

- ``_shape_bytes``, ``_group_size`` and ``collective_bytes`` on
  ``tests/test_roofline.py``'s HLO strings give the reference's bytes.
- ``model_flops`` and ``active_params`` equal the reference's for every
  arch and every cell kind; ``input_specs`` the reference's shapes and
  dtypes for every arch and applicable cell.
- One reduced dry-run cell per family (train, prefill and decode on a
  (2, 2) mesh, shape-only) writes a record whose per-device bytes equal
  what placement puts on a device and whose FLOPs are the
  ``FlopCounterMode`` count of the same step run on real tensors; the
  records tabulate through ``summarize``.
- ``summarize``'s tables and picks equal the reference's on the same
  records; ``hillclimb.VARIANTS`` is the reference's.
- The constants are the H100's.
"""
import ast
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import perf as jperf
from repro.configs import REGISTRY as JREGISTRY
from repro.launch import roofline as jrl
from repro.launch import steps as jsteps
from repro.launch import summarize as jsum
from repro.models import api as japi
from repro.models.config import SHAPES as JSHAPES
from repro_torch import perf as tperf
from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as trl
from repro_torch.launch import steps as tsteps
from repro_torch.launch import summarize as tsum
from repro_torch.models import api as tapi
from repro_torch.models.config import SHAPES, ShapeCell, shape_applicable
from repro_torch.training.optimizer import AdamWConfig, adamw_init

from test_roofline import HLO
from torch_zoo_parity import ARCHS, FAMILY_ARCH

#: small cells for the reduced dry run: one per kind
SMALL = (ShapeCell("train_s", 64, 8, "train"),
         ShapeCell("prefill_s", 64, 4, "prefill"),
         ShapeCell("decode_s", 64, 4, "decode"))


@pytest.mark.parametrize("text", ["bf16[16,4096,896]", "f32[8,128]{1,0}",
                                  "(f32[2,2], s8[4])", "pred[3] u4[7]",
                                  "x[4] s32[]", ""])
def test_shape_bytes_match_reference(text):
    assert trl._shape_bytes(text) == jrl._shape_bytes(text)


@pytest.mark.parametrize("n", [1, 4, 256])
def test_collective_bytes_match_reference(n):
    for text in (HLO, "%x = f32[4]{0} all-reduce(%p), to_apply=%add\n"):
        assert trl.collective_bytes(text, n) == jrl.collective_bytes(text, n)
    for line in HLO.splitlines():
        assert trl._group_size(line, n) == jrl._group_size(line, n)


@functools.lru_cache(maxsize=None)
def abstract(name):
    return (jsteps.abstract_params(JREGISTRY[name]),
            tsteps.abstract_params(REGISTRY[name]))


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_and_active_params_match_reference(name):
    jp, tp = abstract(name)
    n = trl.active_params(REGISTRY[name], tp)
    assert n == jrl.active_params(JREGISTRY[name], jp)
    for jcell, tcell in zip(JSHAPES, SHAPES):
        assert trl.model_flops(REGISTRY[name], tcell, n) == jrl.model_flops(
            JREGISTRY[name], jcell, n)


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_match_reference(name):
    for jcell, tcell in zip(JSHAPES, SHAPES):
        if not shape_applicable(REGISTRY[name], tcell)[0]:
            continue
        want = japi.input_specs(JREGISTRY[name], jcell)
        got = tapi.input_specs(REGISTRY[name], tcell)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[k].shape), (tcell.name, k)
            assert str(spec.dtype).replace("torch.", "") == str(
                want[k].dtype), (tcell.name, k)


def test_constants_are_the_h100s():
    # The reference's test_constants_match_assignment pins the TPU v5e's
    # (197 TFLOP/s, 819 GB/s, 50 GB/s ICI); the port prices its steps for
    # the H100 SXM5 80 GB, from NVIDIA's data sheet, on purpose.
    assert trl.PEAK_FLOPS == 989e12 and trl.PEAK_FLOPS_FP32 == 67e12
    assert trl.HBM_BW == 3.35e12 and trl.NVLINK_BW == 900e9
    assert dryrun.HBM_LIMIT_BYTES == 80 * 1024**3


def test_ring_model_terms():
    r = 1000.0
    assert trl.ring_bytes("all-gather", r, 4) == 750.0
    assert trl.ring_bytes("all-reduce", r, 4) == 1500.0
    assert trl.ring_bytes("reduce-scatter", r, 4) == 3000.0
    assert trl.ring_bytes("collective-permute", r, 4) == r
    assert trl.ring_bytes("all-gather", r, 1) == 0.0
    roof = trl.analyze(trl.StepCost(989e12, 3.35e12, {"all-gather": 9e11}),
                       4, 989e12)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == (1.0, 1.0,
                                                                 1.0)
    assert roof.useful_ratio == 0.25 and roof.coll_bytes == 9e11


# -- the reduced dry run ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reduced_records(family):
    mesh = tmesh.Mesh(("data", "model"), (2, 2))
    cfg = REGISTRY[FAMILY_ARCH[family]].reduced()
    return {c.kind: dryrun.cell_record(cfg, c, mesh) for c in SMALL}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_reduced_dry_run_cells(family, tmp_path, capsys):
    cfg = REGISTRY[FAMILY_ARCH[family]].reduced()
    recs = reduced_records(family)
    for kind, rec in recs.items():
        mem, roof = rec["memory"], rec["roofline"]
        assert rec["replica_batch"] == {"train": 4}.get(kind, 2)
        assert roof["flops"] == rec["flops_replica_step"] > 0
        assert roof["hbm_bytes"] > 0 and roof["n_devices"] == 4
        assert mem["fits_80gb"] and mem["peak_bytes"] >= mem["params_bytes"]
        assert mem["state_bytes"] == sum(
            mem[k] for k in ("params_bytes", "opt_bytes", "grads_bytes",
                             "cache_bytes") if k in mem)
        assert roof["coll_breakdown"]["all-gather"] > 0
        assert ("all-reduce" in roof["coll_breakdown"]) == (kind == "train")
        dryrun._emit({"arch": cfg.name, "shape": f"{kind}_s",
                      "mesh": "single", "kind": kind, "status": "ok", **rec},
                     str(tmp_path), True)
    dryrun._emit({"arch": cfg.name, "shape": "long_s", "mesh": "multi",
                  "kind": "decode", "status": "skipped",
                  "reason": "full-attention arch"}, str(tmp_path), True)
    assert capsys.readouterr().out.count("[dryrun]") == 4
    loaded = tsum.load(str(tmp_path))
    table = tsum.dryrun_table(loaded, "single")
    assert table.count("| ok |") == 3 and "NO" not in table
    assert "skipped" in tsum.dryrun_table(loaded, "multi")
    assert len(tsum.roofline_table(loaded).splitlines()) == 2 + 3
    worst, coll = tsum.pick_hillclimb(loaded)
    assert worst["arch"] == coll["arch"] == cfg.name


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_dry_run_bytes_and_flops_are_the_real_steps(family):
    """The dry run's per-device params and AdamW bytes are what the
    placement puts on each of the (2, 2) mesh's logical devices, and its
    FLOPs those of one train step at the replica's batch on real fp32
    tensors."""
    cfg = REGISTRY[FAMILY_ARCH[family]].reduced()
    cell = SMALL[0]
    meta_mesh = tmesh.Mesh(("data", "model"), (2, 2))
    rec = dryrun.cell_record(cfg, cell, meta_mesh, dtype=torch.float32)
    with tmesh.emulated_devices(4):
        mesh = tmesh.compat_make_mesh((2, 2), ("data", "model"), "cpu")
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    opt = adamw_init(params)
    placed = [tsh.device_put(t, tsh.to_shardings(
        tsh.param_specs(t, mesh, cfg), mesh)) for t in (params, opt)]
    mem = rec["memory"]
    assert tsh.placed_bytes(placed[0]) == [mem["params_bytes"]] * 4
    assert tsh.placed_bytes(placed[1]) == [mem["opt_bytes"]] * 4
    step = tsteps.make_train_step(cfg, AdamWConfig(), cell.seq_len)
    batch = tapi.make_train_batch(cfg, torch.Generator().manual_seed(1),
                                  rec["replica_batch"], cell.seq_len)
    with FlopCounterMode(display=False) as counter:
        step(params, opt, batch)
    assert counter.get_total_flops() == rec["flops_replica_step"]


# -- summarize and hillclimb against the reference ---------------------------------


def reference_records():
    """Records in the reference's layout (its TPU fit key), seeded."""
    rng = np.random.default_rng(0)
    out = []
    for arch in ("a", "b", "c"):
        for shape, mesh in (("train_4k", "single"), ("decode_32k", "single"),
                            ("train_4k", "multi")):
            terms = rng.uniform(0.001, 2.0, 3)
            out.append({
                "arch": arch, "shape": shape, "mesh": mesh,
                "kind": shape.split("_")[0], "status": "ok",
                "compile_s": float(rng.uniform(1, 9)),
                "memory": {"peak_bytes": int(rng.integers(1, 40) * 2**30),
                           "fits_16gb": bool(rng.integers(0, 2))},
                "roofline": {"compute_s": terms[0], "memory_s": terms[1],
                             "collective_s": terms[2],
                             "bottleneck": "compute",
                             "useful_ratio": float(rng.uniform())}})
    out.append({"arch": "d", "shape": "long_500k", "mesh": "single",
                "kind": "decode", "status": "skipped"})
    return out


def test_summarize_tables_match_reference():
    recs = reference_records()
    for mesh in ("single", "multi"):
        assert tsum.dryrun_table(recs, mesh) == jsum.dryrun_table(recs, mesh)
    assert tsum.roofline_table(recs) == jsum.roofline_table(recs)
    assert tsum.pick_hillclimb(recs) == jsum.pick_hillclimb(recs)
    assert tsum.fmt_bytes(3 * 2**30) == jsum.fmt_bytes(3 * 2**30)


def test_hillclimb_variants_are_the_references():
    """The reference module sets XLA_FLAGS when imported, so its
    ``VARIANTS`` are read from its source, evaluated against its perf."""
    src = Path(jperf.__file__).parent / "launch" / "hillclimb.py"
    node = next(n for n in ast.parse(src.read_text()).body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VARIANTS")
    want = eval(compile(ast.Expression(node.value), str(src), "eval"),
                {"perf": jperf})
    assert sorted(hillclimb.VARIANTS) == sorted(want)
    for name, v in hillclimb.VARIANTS.items():
        assert isinstance(v, tperf.PerfVariant)
        assert dataclasses.asdict(v) == dataclasses.asdict(want[name])


def test_hillclimb_runs_a_variant(monkeypatch, tmp_path):
    """A variant's mesh and microbatches reach the dry run, and the
    microbatch override is restored after."""
    monkeypatch.setattr(hillclimb, "OUT", str(tmp_path))
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    seen = []

    def cell_record(cfg, cell, mesh):
        seen.append((mesh.shape, tsteps.pick_microbatches(cfg, cell),
                     tperf.current().name))
        return {"memory": {"peak_bytes": 0, "fits_80gb": True},
                "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                             "collective_s": 0.5, "bottleneck": "memory",
                             "useful_ratio": 0.5}}

    monkeypatch.setattr(dryrun, "cell_record", cell_record)
    rec = hillclimb.run("qwen3-1.7b", "train_4k", "fsdp_sp_mb8")
    assert rec["variant"] == "fsdp_sp_mb8" and rec["status"] == "ok"
    assert seen == [({"data": 16, "model": 16}, 8, "fsdp_sp_mb8")]
    assert (tmp_path / "qwen3-1.7b__train_4k__fsdp_sp_mb8.json").exists()
    hillclimb.run("qwen3-1.7b", "train_4k", "tp4")
    assert seen[-1][0] == {"data": 64, "model": 4}
    import os
    assert "REPRO_MICROBATCHES" not in os.environ
