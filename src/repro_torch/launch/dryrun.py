"""Dry run: every (architecture x input-shape) cell on the production
meshes, on shape-only ``meta`` tensors; port of
``repro/launch/dryrun.py``.  It allocates nothing and needs no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k

Where the reference lowers and compiles each cell with XLA and reads its
cost and memory analyses, the port prices the step it would run under
its own sharded design (``launch/steps.py``: each data replica computes
its slice of the batch on whole, gathered weights; the "model" axis
shards storage only).  Per cell, per device:

* **state bytes**: each leaf of the params, the AdamW state and (train)
  the gradients, its bytes divided by the product of the axis sizes its
  ``param_specs`` spec shards over (the decode cache by ``cache_specs``)
  -- exactly what ``NamedSharding.place`` puts on a device;
* **FLOPs and bytes**: ``torch.utils.flop_counter.FlopCounterMode`` and
  a count of every op's input and output bytes over one ``meta`` step
  (train, prefill or decode) at one replica's batch: what the busiest
  device computes.  The port's layer loop is Python, so every layer is
  counted: the reference's two reduced-depth probes, which undo XLA's
  once-per-while-loop count, are not needed;
* **collective bytes**, by the reference's ring model from the specs:
  the all-gather of every sharded weight (and cache) leaf, for training
  the all-reduce of the gradients over the data replicas and the
  scatter of the reduced gradients back to the shards;
* **peak bytes**: the device's placed state (params, optimizer state,
  cache), the step's whole inputs on the compute device, and the peak
  of the tensors the ``meta`` step keeps alive at once; the cell fits
  when that is under ``HBM_LIMIT_BYTES``.

Records go to ``build/dryrun/{arch}__{shape}__{mesh}.json`` in the
reference's layout (``launch/summarize.py`` tabulates either).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _tree, perf
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.distributed.sharding import (_axes, batch_spec, cache_specs,
                                              is_spec, param_specs)
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (axis_size, compat_make_mesh, data_axes,
                                     make_production_mesh)
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      n_params_of, pick_microbatches,
                                      quantize_params_abstract)
from repro_torch.models import api
from repro_torch.models.config import SHAPES, ShapeCell, shape_applicable
from repro_torch.training.optimizer import AdamWConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

HBM_LIMIT_BYTES = 80 * 1024**3  # H100 SXM5 80 GB HBM3 (data sheet)


def _specs(spec_tree):
    out = []
    _tree.tree_map(out.append, spec_tree, is_leaf=is_spec)
    return out


def _spec_size(spec, mesh) -> int:
    return math.prod(axis_size(mesh, *_axes(e)) for e in spec)


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree`` on one device: each leaf's bytes over the
    product of the axis sizes its spec shards over."""
    return sum(leaf.numel() * leaf.element_size() // _spec_size(spec, mesh)
               for leaf, spec in zip(_tree.leaves(tree), _specs(specs)))


def _tree_bytes(tree) -> int:
    return sum(l.numel() * l.element_size() for l in _tree.leaves(tree)
               if isinstance(l, torch.Tensor))


def _gather_bytes(tree, specs, mesh) -> float:
    """Ring-model bytes per device of gathering every leaf its spec
    shards from its blocks (and of the scatter back, which moves the
    same)."""
    return sum(RL.ring_bytes("all-gather", leaf.numel() * leaf.element_size(),
                             _spec_size(spec, mesh))
               for leaf, spec in zip(_tree.leaves(tree), _specs(specs)))


class _StepBytes(TorchDispatchMode):
    """Counts the bytes every op reads and writes (views move nothing)
    and the peak bytes of the tensors created under it that are alive at
    once (by storage: a view keeps its base's storage alive)."""

    def __init__(self):
        super().__init__()
        self.moved = 0
        self.live = self.peak = 0
        self._refs = {}

    def _free(self, key, nbytes):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.moved += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            if any(t is i for i in ins):
                continue                     # written in place
            storage = t.untyped_storage()
            key, nbytes = storage._cdata, storage.nbytes()
            if key not in self._refs:
                self._refs[key] = 0
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            self._refs[key] += 1
            weakref.finalize(t, self._free, key, nbytes)
        return out


def _replica_batch(cell: ShapeCell, mesh) -> int:
    """The batch one data replica computes: its slice where the data
    axes divide the global batch, else the whole (replicated) batch."""
    b = cell.global_batch
    if batch_spec((b,), mesh)[0] is None:
        return b
    return b // axis_size(mesh, *data_axes(mesh))


def _measure(fn):
    """(flops, bytes moved, live peak) of ``fn()`` on ``meta`` tensors."""
    counter, moved = FlopCounterMode(display=False), _StepBytes()
    with counter, moved:
        out = fn()
        del out
    return float(counter.get_total_flops()), float(moved.moved), moved.peak


def cell_record(cfg, cell: ShapeCell, mesh, dtype=torch.bfloat16) -> dict:
    """The port's dry-run record of one cell on ``mesh`` (shape-only):
    per-device memory, the roofline of one replica's step, the counts
    behind them (see the module docstring)."""
    params = abstract_params(cfg, dtype)
    p_specs = param_specs(params, mesh, cfg)
    n_dev = mesh.size
    rb = _replica_batch(cell, mesh)
    rcell = dataclasses.replace(cell, global_batch=rb)
    mem = {"params_bytes": per_device_bytes(params, p_specs, mesh)}
    coll = {"all-gather": _gather_bytes(params, p_specs, mesh)}
    inputs = api.input_specs(cfg, rcell, dtype)
    gathered = _tree_bytes(params) + _tree_bytes(inputs)
    placed = mem["params_bytes"]

    if cell.kind == "train":
        opt = abstract_opt_state(params)
        mem["opt_bytes"] = per_device_bytes(
            opt, param_specs(opt, mesh, cfg), mesh)
        mem["grads_bytes"] = mem["params_bytes"]
        placed += mem["opt_bytes"]
        d = axis_size(mesh, *data_axes(mesh)) if rb < cell.global_batch else 1
        coll["all-reduce"] = RL.ring_bytes("all-reduce", _tree_bytes(params),
                                           d)
        coll["scatter"] = coll["all-gather"]
        mb = math.gcd(pick_microbatches(cfg, cell), rb)
        step = make_train_step(cfg, AdamWConfig(), cell.seq_len,
                               microbatches=mb)
        flops, moved, peak = _measure(lambda: step(params, opt, inputs))
    elif cell.kind == "prefill":
        step = make_prefill_step(cfg, cell.seq_len)
        with torch.no_grad():
            flops, moved, peak = _measure(
                lambda: step(params, inputs["inputs"]))
    else:
        cache = abstract_cache(cfg, cell, dtype)
        c_specs = cache_specs(cache, mesh)
        mem["cache_bytes"] = per_device_bytes(cache, c_specs, mesh)
        placed += mem["cache_bytes"]
        replica_cache = abstract_cache(cfg, rcell, dtype)
        gathered += _tree_bytes(replica_cache)
        arg0 = params
        if perf.current().int8_weights:
            arg0 = quantize_params_abstract(params)
            q_specs = param_specs(arg0["q"], mesh, cfg)
            mem["params_bytes"] = per_device_bytes(arg0["q"], q_specs, mesh)
            placed = mem["params_bytes"] + mem["cache_bytes"]
            coll["all-gather"] = _gather_bytes(arg0["q"], q_specs, mesh)
            gathered += _tree_bytes(arg0) - _tree_bytes(params)
        step = make_serve_step(cfg)
        with torch.no_grad():
            flops, moved, peak = _measure(
                lambda: step(arg0, replica_cache, inputs["inputs"]))

    mem["state_bytes"] = sum(v for k, v in mem.items() if k.endswith("bytes"))
    mem.update(gathered_bytes=gathered, step_peak_bytes=peak,
               peak_bytes=placed + gathered + peak)
    mem["fits_80gb"] = bool(mem["peak_bytes"] < HBM_LIMIT_BYTES)
    n_active = RL.active_params(cfg, params)
    roof = RL.analyze(RL.StepCost(flops, moved, coll), n_dev,
                      RL.model_flops(cfg, cell, n_active))
    return {"n_params": n_params_of(params), "n_active_params": n_active,
            "replica_batch": rb, "flops_replica_step": flops,
            "memory": mem, "roofline": roof.to_dict()}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True) -> dict:
    cfg = get_arch(arch_name)
    cell = {c.name: c for c in SHAPES}[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    record = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
              "kind": cell.kind, "status": "?"}

    ok, reason = shape_applicable(cfg, cell)
    if not ok:
        record.update(status="skipped", reason=reason)
        _emit(record, out_dir, verbose)
        return record

    t0 = time.time()
    mo = perf.current().mesh_override
    if mo is not None:
        mesh = compat_make_mesh(mo[0], mo[1], "meta")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    record.update(cell_record(cfg, cell, mesh))
    record.update(status="ok", trace_s=round(time.time() - t0, 1))
    _emit(record, out_dir, verbose)
    return record


def _emit(record: dict, out_dir: Optional[str], verbose: bool):
    out_dir = out_dir or os.path.abspath(OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    if not verbose:
        return
    if record["status"] == "ok":
        m = record["memory"]
        msg = (f"[dryrun] {record['arch']:24s} {record['shape']:12s} "
               f"{record['mesh']:6s} OK  peak={m['peak_bytes']/2**30:7.2f}GiB"
               f"{'' if m['fits_80gb'] else ' OVER'}")
        r = record["roofline"]
        msg += (f" compute={r['compute_s']*1e3:9.2f}ms"
                f" mem={r['memory_s']*1e3:9.2f}ms"
                f" coll={r['collective_s']*1e3:9.2f}ms"
                f" -> {r['bottleneck']}  useful={r['useful_ratio']:.2f}")
        print(msg, flush=True)
    else:
        print(f"[dryrun] {record['arch']:24s} {record['shape']:12s} "
              f"{record['mesh']:6s} {record['status'].upper()}: "
              f"{record.get('reason', '')}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(REGISTRY)
    shapes = [args.shape] if args.shape else [c.name for c in SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, mp, args.out)
                    if rec["status"] not in ("ok", "skipped"):
                        failures.append((arch, shape, mp))
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp))
                    _emit({"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "kind": "?", "status": "error",
                           "reason": repr(e)[:500]}, args.out, True)
    if failures:
        print(f"FAILURES: {failures}", flush=True)
        raise SystemExit(1)
    print("dry-run complete: all cells OK", flush=True)


if __name__ == "__main__":
    main()
