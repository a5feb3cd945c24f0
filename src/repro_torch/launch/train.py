"""Production training launcher of the model zoo; port of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 4 --batch 4 --seq 32 --device cpu

It trains on the visible cards (``--device``, ``cuda`` by default; ``cpu``
runs on the host): the mesh is ``best_mesh_for`` their count, and the
params and optimizer state are placed on it by the partition rules
(``distributed/sharding.py``); on a mesh of several devices
``launch/steps.py`` takes its sharded step.  Inside
``launch.mesh.emulated_devices(n)`` the mesh spans ``n`` logical copies
of the one host device or of ``cuda:0``.

Fault tolerance: it resumes from the latest committed checkpoint
(params, optimizer, data position); preemption mid-step costs at most
``--ckpt-every`` steps.  A checkpoint holds host arrays gathered from
the shards, and a restore places them by the rules again, so a run may
resume on another mesh (``launch/elastic.py``).  The paper's technique
is first-class: ``--cbtd-gamma`` prunes every linear with CBTD after
every ``--cbtd-every``-th step (Alg. 2), and the LM data stream is the
synthetic pipeline (``data/lm.py``).  The loss is read on the host only
on log steps.

Seeds: the params are drawn from a generator seeded 0 (the reference's
``key(0)``); the vlm and audio families draw each step's batch with
``api.make_train_batch`` from a generator seeded ``seed_for(0, step)``
(the reference's ``fold_in(key, step)``), and advance the LM stream's
position without drawing the batch the reference draws and discards.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import alpha_at, cbtd_prune_tree
from repro_torch.core.cbtd import _match_layout
from repro_torch.data.lm import LMConfig, LMDataset, seed_for
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              device_put, gather, host_tree,
                                              param_specs, to_shardings)
from repro_torch.launch.elastic import best_mesh_for
from repro_torch.launch.mesh import mesh_context, visible_devices
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, adamw_init


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the final params and optimizer state, the data
    stream, the step it resumed from, and the losses read on log steps
    (by 1-based step) with the wall seconds per step of each log
    window."""
    params: object
    opt_state: object
    data: LMDataset
    step0: int
    losses: Dict[int, float]
    window_s_per_step: List[float]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--cbtd-gamma", type=float, default=None)
    ap.add_argument("--cbtd-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "trains on the host)")
    return ap.parse_args(argv)


def adamw_config(args) -> AdamWConfig:
    """The run's optimizer: warmup over a fifth of the steps (at most 20),
    then a cosine decay to the last step."""
    return AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                       schedule="cosine", total_steps=args.steps)


def prune_layout(cfg, gamma: Optional[float]):
    """``api.cbtd_layout`` at ``gamma``; None when CBTD is off."""
    if not gamma:
        return None
    return {k: dataclasses.replace(v, gamma=gamma)
            for k, v in api.cbtd_layout(cfg).items()}


def prune(params, layout, alpha):
    """``cbtd_prune_tree``.  A sharded leaf of the layout is pruned whole
    and split again: Alg. 1 ranks whole M-row subcolumns, and a shard
    boundary inside one would change which weights are kept."""
    def whole(path, x):
        if isinstance(x, ShardedTensor) and _match_layout(path, layout):
            return gather(x, x.mesh.devices[0])
        return x

    pruned = cbtd_prune_tree(_tree.map_with_path(whole, params), layout,
                             alpha)
    return _tree.tree_map(
        lambda new, old: (NamedSharding(old.mesh, old.spec).place(new)
                          if isinstance(old, ShardedTensor)
                          and not isinstance(new, ShardedTensor) else new),
        pruned, params)


def next_batch(cfg, data: LMDataset, step: int, batch: int, seq: int):
    """The batch of 0-based ``step``: the LM stream's next for the token
    families; for vlm and audio ``api.make_train_batch`` from a generator
    seeded ``seed_for(0, step)``, the stream's position advanced without
    a draw."""
    if cfg.family in ("vlm", "audio"):
        data.step += 1
        gen = torch.Generator(data.device).manual_seed(seed_for(0, step))
        return api.make_train_batch(cfg, gen, batch, seq)
    tokens, targets = next(data)
    return {"tokens": tokens, "targets": targets}


def train(args) -> TrainRun:
    device = resolve_device(args.device)
    n_dev = len(visible_devices(device))
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    mesh = best_mesh_for(n_dev, device)
    print(f"[train] arch={cfg.name} mesh={mesh.shape} devices={n_dev}",
          flush=True)

    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             torch.float32, device)
    opt_state = adamw_init(params)

    p_sh = to_shardings(param_specs(params, mesh, cfg), mesh)
    o_sh = to_shardings(param_specs(opt_state, mesh, cfg), mesh)
    params = device_put(params, p_sh)
    opt_state = device_put(opt_state, o_sh)

    data = LMDataset(LMConfig(vocab=cfg.vocab, seq_len=args.seq),
                     args.batch, 0, device=device)

    step0 = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=2, async_save=True)
        (params, opt_state), meta, ck = mgr.restore_latest((params, opt_state))
        if ck is not None:
            step0 = int(meta["step"])
            data.load_state_dict({"step": meta["data_step"]})
            params = device_put(params, p_sh)
            opt_state = device_put(opt_state, o_sh)
            print(f"[train] resumed from step {step0}", flush=True)

    train_step = make_train_step(cfg, adamw_config(args), args.seq,
                                 microbatches=args.microbatches)
    layout = prune_layout(cfg, args.cbtd_gamma)

    losses, windows = {}, []
    with mesh_context(mesh):
        t0 = time.time()
        for step in range(step0, args.steps):
            batch = next_batch(cfg, data, step, args.batch, args.seq)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            if layout and (step + 1) % args.cbtd_every == 0:
                alpha = alpha_at(step // args.cbtd_every, 0.2)
                params = prune(params, layout, alpha)
            if (step + 1) % args.log_every == 0:
                losses[step + 1] = float(metrics["loss"])
                windows.append((time.time() - t0) / args.log_every)
                print(f"step {step+1:5d} loss {losses[step + 1]:.4f} "
                      f"({windows[-1]:.2f}s/step)", flush=True)
                t0 = time.time()
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, host_tree((params, opt_state)),
                         {"step": step + 1, "data_step": data.step})
        if mgr:
            mgr.save(args.steps, host_tree((params, opt_state)),
                     {"step": args.steps, "data_step": data.step})
            mgr.wait()
    print("[train] done", flush=True)
    return TrainRun(params, opt_state, data, step0, losses, windows)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    try:
        return train(args)
    except RuntimeError as exc:
        if "CUDA" not in str(exc):
            raise
        sys.exit(f"train: {exc} (on the launcher: --device cpu)")


if __name__ == "__main__":
    main()
