#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]
    python3 chip_smoke.py --boundary-only [--src DIR] [--label NAME]
    python3 chip_smoke.py --sharded-only [--out DIR]

Details (nvcc log, serving report, mirror cost, profile) go to DIR, by
default ``build/chip_smoke/``.  ``--boundary-only`` prints just the
chunked pool's boundary costs of the tree whose ``src`` is DIR (the
retirement fetch's wait, the dispatch's host time, the chunk's device
span, ``host_overlap_frac``; see ``boundary_only``): to compare two
commits, unpack the parent with ``git archive`` and run both trees in
turns in one call.  ``--sharded-only`` builds the kernels and runs
phases 9 and 10 alone, on as many cards as are visible (with four, N = 2
and 4 shards and the sharded trainer's meshes run on distinct cards).

Phases; any failure exits non-zero before a result line is printed:

1. Device: the card's name and power limit (``nvidia-smi``).  Exits 1
   when ``torch.cuda.is_available()`` is false.
2. Build and kernels: builds the CUDA kernels from ``src/repro_torch/
   kernels/csrc`` with nvcc, then holds each of the six kernels against
   its plain PyTorch version on the card at the serving shapes of the
   paper's 2x1024 DeltaLSTM: the dense-mirror product ``torch.equal`` to
   its float64 plain version (any element that differs fails, printed
   with its ulps) at B = 1, 4, 8, 16 and 32 on both layers, fp32 and
   int8 packs, 30% and 5% of the deltas fired, each row equal to the
   same row alone; the capacity clip's ``ds`` and ``n_dropped`` bit for
   bit at B = 1, 4, 8, 16 and 32 on both layers, on served traffic and
   on overflow with ties; the fused IPU and HPE
   layer-step stages
   bit for bit (``torch.equal``, 12 of 16 slots active, state updated in
   place), the reference's call shapes at 1e-6 with exact fired counts,
   the SpMV bit-identical to the plain scatter on the host, whose per-row
   sum order it keeps, and within 1e-5 of the card's plain versions,
   which sum in another order.  Times the kernel, the plain version, the
   PyTorch glue launches the fused stages replace and, where one exists,
   a PyTorch library call that computes the same function (per call, and
   device time alone).
3. Serving at full width: ``DELTA_LSTM_2L_1024H`` (D=123, H=1024, 2
   layers, theta=0.3) from seeded weights, CBTD-pruned at gamma=0.9375,
   M=64 (kept weights scaled by 1/(1-gamma): see ``servable_params``),
   served by ``serve_requests`` (capacity 16, 32 requests of 100-300
   frames, chunk_frames=16) on three routes: the dense mirror ("auto"),
   the CBCSC scatter kernel, and scatter + int8.  Each run checks pool vs
   the batch-1 engine on the card (1e-5), the card vs the same pool on the
   CPU (1e-4 on 4 requests cut to 64 frames: fp32 sums run in another
   order on the two, compounded through two recurrent layers), and that
   every kernel of the route was launched, counting the pool's launches
   and the batch-1 engine's apart.  Then the dense-mirror kernel's cost
   against a plain fp32 ``torch.matmul`` and the float64 cuBLAS product
   it replaced, the weight bytes the fp32 pack saved, and the dense route
   served with an fp32 matmul swapped in (``mirror_cost``), and a profile
   of one wave per route (device launches per layer-frame, busy time,
   idle share).
4. Streaming front-end at full width: ``AsyncSpartusServer`` over the
   same model (theta=0.3) on the dense-mirror and scatter routes,
   capacity 16, chunk_frames=16, ticks offloaded to a worker thread,
   ``PoolObservability`` on.  32 clients arrive staggered and drip-feed
   seeded 100-300-frame utterances in blocks of 1-32 frames with seeded
   gaps; two cancel mid-utterance; one is a slow consumer (partial
   queues bound at 2) that drains two blocks halfway and the rest at the
   end.  Checks, per route: each completed client's partials equal its
   result bit for bit, the results are ``serve_requests``' on the card
   within 1e-5, cancelled clients get no result and the pool ends empty,
   the slow consumer's backfill covers its gap, every client's logits
   change over time, every kernel of the route launched on this path
   (counted as path ``stream``), and one injected ``dispatch`` fault with
   the watchdog on recovers once, with every survivor equal to the
   undisturbed run bit for bit.  The timed run is made with torch's
   sync debug mode at "error": a blocking copy or synchronize anywhere
   on the served path fails it.  The admin endpoint's healthz, stats,
   metrics and timeseries are scraped mid-run.  Prints frames/s, latency
   p50/p99, first-logit p50, queue-wait p95, dispatches per frame,
   ``host_overlap_frac`` and ``tick()`` wall time, split into the
   dispatch's host time, the fetch's wait and the observability fold,
   beside each chunk's device span.  Then the launcher runs as a
   subprocess in both its modes (``python -m repro_torch.launch.serve
   --spartus --async --pool 16 --chunk-frames 16 --clients 8 --hidden
   1024``, and ``--spartus --pool 4 --requests 8 --chunk-frames 16``,
   which trains at its default width before it serves).
5. Training at full width: ``pretrain_retrain`` of ``LSTM_2L_1024H`` on
   the card (batch 16 of 64-frame synthetic utterances, CBTD
   gamma=0.9375, M=64, 3 pretrain epochs at delta_alpha 0.5 so that the
   last runs at alpha = 1, then 1 DeltaLSTM retrain epoch at theta=0.3,
   5 steps each).  Checks a falling loss and the pretrain's weight
   sparsity (0.9375 +- 0.01 on ``w_x``, ``w_h``, ``fcl/w``), prints the
   step time, then serves the trained weights unscaled on the "auto" and
   scatter routes (phase 3's requests) and one utterance on the batch-1
   engine per route: pool vs batch-1 (1e-5), logits not all zero and
   changing across frames, temporal sparsity in (0, 1), the pack's
   overflow, launches counted as path ``trained``.
6. Contracts and the rest of the slice: every hot-path contract case
   (``repro_torch.analysis.cases``: the reference's 14, its sharded case
   on 4 logical shards, and the served routes at the served NZI
   capacity) checked on the card at test scale
   and at full width (capacity 16, 16-frame chunks), each traced call
   under sync debug mode "error", zero violations ("contracts:" line);
   DeltaGRU and DeltaLinear at H=1024, D=123 over 64 frames on the card
   against the CPU (1e-4) and DeltaGRU at theta 0 against the GRU;
   ``repro_torch.examples.delta_transformer_decode`` at its published
   sizes.
7. The model zoo (``repro_torch.models.api``, plain PyTorch ops: the
   reference's zoo reaches no Pallas kernel, and none of the six
   kernels launches here).  ``qwen2-0.5b``, ``granite-moe-1b-a400m``,
   ``mamba2-130m`` and ``seamless-m4t-medium`` at full width, fp32
   weights drawn on the card from a seeded generator: 32 greedy decode
   steps at B=4 with a 128-slot cache through ``api.serve_step`` (as the
   launcher's ``serve_arch``), ms/token, device launches and busy share
   of one profiled step, and the step's weight-byte bound; logits finite
   and changing across steps.  Decode stepped over 8 tokens at B=1
   against the teacher-forced forward at the reference test's gate (rtol
   2e-2, atol 2e-3) for the dense, ssm and audio models; the forward
   (B=1, 8 tokens) on the card against the CPU within 1e-4 of max|logits|
   for qwen2 and granite-moe (a MoE token routed apart by a router
   near-tie is reported with its layer).  Then all ten registry archs at
   ``.reduced()``, card vs CPU (forward over 16 tokens, 8 decode steps,
   1e-4 relative), and the launcher's ``--arch qwen2-0.5b --batch 4
   --steps 32`` as a subprocess.  JSON: ``<out>/chip_smoke_zoo.json``.
8. The model zoo's trainer (``repro_torch.launch.{train,steps}``,
   ``data/lm.py``; plain PyTorch, none of the six kernels launches):
   ``qwen2-0.5b``, ``granite-moe-1b-a400m``, ``mamba2-130m`` and
   ``seamless-m4t-medium`` at full width, fp32, AdamW, B=8, S=256, remat
   on.  Per arch: step 1's gradients (every leaf nonzero), one
   ``train_step`` under sync debug mode "error" with its peak memory
   against params + grads + m + v + the activations remat keeps, one
   under torch.profiler (device launches, busy ms, idle share), the
   step's FLOP bound at 67 TFLOP/s, the batch's ms (the LM stream for
   the token families) and one CBTD prune's ms; then the launcher
   (``main``) for 18 steps at ``--cbtd-gamma 0.5 --cbtd-every 3``: losses
   finite and falling, step ms (the median of its per-step windows, the
   first and the prune steps left out) and tokens/s, and after the last
   step's prune at alpha = 1 every subcolumn of every layout leaf holding
   exactly floor(gamma H / M) zeros.  On mamba2-130m a 4-step run
   checkpoints, its checkpoint restores ``torch.equal``, and the
   launcher resumed at step 4 draws the uninterrupted run's batch.  Then
   the ten archs at ``.reduced()``, one ``make_train_step`` card vs CPU
   (loss and gradients 1e-4, params 1e-4 of max|param|, Adam's sign-free
   elements counted).  JSON: ``<out>/chip_smoke_zoo_train.json``.
9. Sharded serving at full width (``SessionPool(n_devices=N)``,
   ``serving/sharding.py``): phase 3's model and 32 requests through
   ``serve_requests`` at capacity 16 with N = 1, 2 and 4 shards on the
   "auto" and scatter routes and N = 1 and 4 on scatter+int8, on N
   distinct cards where that many are visible, else as N logical shards
   on the one card (the script prints which).  Each run: vs the batch-1
   engine within 1e-5; vs the unsharded pool (N = 1) ``torch.equal``
   where the route's chunk is batch-invariant at the shard's batch (its
   head's fp32 GEMMs, checked alone), else within 1e-5, the gap printed;
   frames/s, host ms per dispatch (every shard's ``step_chunk``) and,
   from one wave under torch.profiler, device launches per layer-frame
   and the idle share.  Then capacity 6 over 4 shards (one shard, the
   unsharded logits), least-loaded admission in ``shard_loads()``, and
   ``AsyncSpartusServer(n_devices=4)`` with phase 4's 32 drip-fed clients
   under sync debug mode "error".  Launches are counted as path
   ``sharded``, the batch-1 oracle of the checks included.  JSON:
   ``<out>/chip_smoke_sharded.json``.
10. Sharded training at full width (``launch/train.py`` on a mesh of
   several devices: ``ShardedTensor`` leaves, the sharded step of
   ``launch/steps.py``): ``qwen2-0.5b`` and ``granite-moe-1b-a400m`` in
   phase 8's cell (fp32 AdamW, B=8, S=256, remat, ``--cbtd-gamma 0.5
   --cbtd-every 3``) for 4 steps on ``best_mesh_for(4)`` = (1, 4), on 4
   distinct cards where that many are visible, else on 4 logical devices
   of cuda:0 (``emulated_devices``).  Its losses and its final params and
   AdamW state (gathered) are ``torch.equal`` to the same launcher's run
   on one device (data size 1).  Its checkpoint (host arrays gathered
   from the shards) restores bit for bit and is placed onto a (2, 2)
   mesh, which takes 2 more steps (data size 2) with finite losses,
   printed beside the one-device continuation's.  Per mesh: the step ms,
   one profiled step's device launches and idle share, peak memory per
   card, the bytes placed on each mesh device, which must equal the dry
   run's per-device count for that mesh exactly
   (``launch/dryrun.py``, fp32), and the dry run's FLOPs of one replica's
   step beside phase 8's ``train_step_flops``.  None of the six kernels
   launches (path ``sharded_train``).  JSON:
   ``<out>/chip_smoke_sharded_train.json``.
11. Prints the card's name and power limit, ``{"kernels": [...]}`` and
   then, as the last line, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
TOL_ELEMENTWISE = 1e-6
TOL_SPMV = 1e-5
TOL_POOL_VS_BATCH1 = 1e-5
TOL_CARD_VS_CPU = 1e-4
CAPACITY, N_REQUESTS, CHUNK_FRAMES = 16, 32, 16
MIN_FRAMES, MAX_FRAMES = 100, 300
CPU_CHECK_REQUESTS, CPU_CHECK_FRAMES = 4, 64
GAMMA, M = 0.9375, 64
N_STREAM_CLIENTS, MAX_BLOCK, PARTIAL_QUEUE_LEN = 32, 32, 2
CANCELLED_CLIENTS, SLOW_CLIENT = (5, 17), 9
STREAM_ROUTES = ("auto", "scatter")
LAUNCHER_TIMEOUT_S = 300
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS_PER_EPOCH = 16, 64, 5
PRETRAIN_EPOCHS, RETRAIN_EPOCHS, DELTA_ALPHA = 3, 1, 0.5
TRAINED_ROUTES = ("auto", "scatter")
# phase 9's per-shard batches (capacity 16 over N = 2 and 4 shards): each
# kernel is also held against its plain version there in phase 2
SHARD_BATCHES = (CAPACITY // 2, CAPACITY // 4)
MIRROR_BATCHES = (1, *sorted(SHARD_BATCHES), CAPACITY, 2 * CAPACITY)
# the bulk bench's pool size (bench/traffic/bulk.json's server capacity):
# the capacity clip is also held against its plain version there
BULK_POOL = 1024
# the dense-mirror kernel's fired shares in phase 2: 30%, and the served
# model's ~5% (the trained 2x1024 model's temporal sparsity is 0.955)
MIRROR_SHARES = (0.3, 0.05)
ZOO_FULL = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-130m",
            "seamless-m4t-medium")
ZOO_DECODE_CHECKED = ("qwen2-0.5b", "mamba2-130m", "seamless-m4t-medium")
ZOO_CPU_CHECKED = ("qwen2-0.5b", "granite-moe-1b-a400m")
ZOO_BATCH, ZOO_CTX, ZOO_STEPS = 4, 128, 32
ZOO_CHECK_TOKENS, ZOO_ENC_FRAMES = 8, 12
ZOO_REDUCED_TOKENS, ZOO_REDUCED_STEPS = 16, 8
ZOO_DECODE_RTOL, ZOO_DECODE_ATOL = 2e-2, 2e-3   # tests/test_arch_smoke.py
ZOO_NEAR_TIE = 1e-4
ZOO_TRAIN = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-130m",
             "seamless-m4t-medium")
ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ, ZOO_TRAIN_STEPS = 8, 256, 18
# prunes after every 3rd step at alpha_at(step // 3, 0.2): 0, 0.2, ...,
# 0.8, then 1 at step 18, the only prune that drops weights
ZOO_TRAIN_GAMMA, ZOO_TRAIN_EVERY = 0.5, 3
ZOO_RESUME_ARCH, ZOO_RESUME_AT = "mamba2-130m", 4
# leaves the reference also leaves without gradient at step 1 (the vlm
# family's inputs_embeds bypass the embedding; tests/torch_zoo_parity.py)
ZOO_ZERO_GRAD = {"pixtral-12b": ("embed",)}
TOL_SIGN_FREE_SHARE = 0.02
SPARTUS_LAUNCHES = (
    (["--spartus", "--async", "--pool", "16", "--chunk-frames", "16",
      "--clients", "8", "--hidden", "1024", "--admin-port", "0"],
     ["8 concurrent TCP clients served"]),
    (["--spartus", "--pool", "4", "--requests", "8", "--chunk-frames", "16"],
     ["[serve] pool(4, chunked x16): 8 sessions", "pack overflow",
      "modelled Spartus latency"]),
)
# phase 9: (route, int8, shard counts); N=1 is the unsharded baseline
SHARD_ROUTES = (("auto", False, (1, 2, 4)), ("scatter", False, (1, 2, 4)),
                ("scatter", True, (1, 4)))
SHARD_FALLBACK_CAPACITY = 6
# phase 10: phase 8's cell on SHARD_TRAIN_DEVICES devices, the first
# SHARD_TRAIN_STEPS steps on best_mesh_for(4) = (1, 4), then
# SHARD_TRAIN_MORE after a restore onto (2, 2)
SHARD_TRAIN = ("qwen2-0.5b", "granite-moe-1b-a400m")
SHARD_TRAIN_DEVICES, SHARD_TRAIN_STEPS, SHARD_TRAIN_MORE = 4, 4, 2
TOL_SHARD_LOSS = 1e-5
SHARD_STREAM_SEED = 9
ARCH_LAUNCHES = (
    (["--arch", "qwen2-0.5b", "--batch", "4", "--steps", "32"],
     ["[serve] qwen2-0.5b: 32 steps batch=4 -> "]),
)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 100, warmup: int = 5) -> float:
    """CUDA-event time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def self_device_us(evt) -> float:
    """An event's own device time (its children's excluded), so that a
    sum over every event counts each kernel once."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, kernel: str, iters: int = 50):
    """Mean device time of the device events whose name contains
    ``kernel`` (every event of the call for "") per call of ``fn``, from
    torch.profiler; None if the profiler recorded no such event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(self_device_us(evt) for evt in prof.key_averages()
                   if kernel in evt.key)
    return total_us / iters / 1e3 if total_us else None


def profile_step(torch, fn):
    """One call of ``fn`` under torch.profiler: wall ms (ending in a
    sync), device busy ms and share, device launches, the kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if self_device_us(e) > 0), key=lambda e: -self_device_us(e))
    busy = sum(self_device_us(e) for e in events) / 1e6
    return {"profiled_step_wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "device_busy_share": busy / wall,
            "device_launches_per_step": sum(e.count for e in events),
            "by_kernel": [{"name": e.key[:90], "device_ms":
                           self_device_us(e) / 1e3, "count": e.count}
                          for e in events[:6]]}


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def kernel_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import capacity_clip as cc
    from repro_torch.kernels import delta_encode as de
    from repro_torch.kernels import dense_mirror as dm
    from repro_torch.kernels import lstm_pointwise as lp
    from repro_torch.kernels import stsp_spmv as sp

    return {"delta_encode": de.KERNEL, "lstm_pointwise": lp.KERNEL,
            "stsp_spmv_scatter_batch": sp.SCATTER_BATCH_KERNEL,
            "stsp_spmv": sp.KERNEL, "dense_mirror": dm.KERNEL,
            "capacity_clip": cc.KERNEL}


def zero_counts(counters) -> None:
    for kern in counters.values():
        kern.launches = 0


def read_counts(torch, counters):
    torch.cuda.synchronize()
    return {name: kern.launches for name, kern in counters.items()}


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def servable_params(lstm_am, am_cfg, seed: int):
    """Seeded weights from the port's ``init_params``, CBTD-pruned at
    gamma=0.9375, M=64, with the kept LSTM weights scaled by the inverse
    keep fraction 1/(1-gamma) = 16 (as inverted dropout does).  Without
    that gain the pruned random network's hidden state never moves by
    theta=0.3 in a frame: layer 2 receives no delta and every logit is
    exactly 0, which would make the serving checks vacuous."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(gen, am_cfg, device="cuda"), gamma=GAMMA, m=M)
    gain = 1.0 / (1.0 - GAMMA)
    params["lstm"] = [{**lp, "w_x": lp["w_x"] * gain, "w_h": lp["w_h"] * gain}
                      for lp in params["lstm"]]
    return params


# -- phase 2: kernels against their plain versions ---------------------------


def pointwise_step_case(torch, lp, g, dev, b: int, h_dim: int):
    """The fused accumulate + HPE stage at batch ``b``, 3 of every 4 slots
    active: ``torch.equal`` to its plain version, and its case row."""
    active = torch.arange(b, device=dev) % 4 != 3
    n_active = int(active.sum())
    am = active[:, None]
    dm0 = 2 * torch.randn((b, 4 * h_dim), generator=g, device=dev)
    y = 0.01 * torch.randn((b, 4 * h_dim), generator=g, device=dev)
    c0 = torch.randn((b, h_dim), generator=g, device=dev)
    hid0 = torch.randn((b, h_dim), generator=g, device=dev)
    got_state = [t.clone() for t in (dm0, c0, hid0)]
    want_state = [t.clone() for t in (dm0, c0, hid0)]
    got = lp.lstm_pointwise_step(got_state[0], y, *got_state[1:], active)
    want = lp.plain_step(want_state[0], y, *want_state[1:], active)
    check(torch.equal(got, want) and all(
        torch.equal(u, v) for u, v in zip(got_state, want_state)),
        f"lstm_pointwise_step B={b}: differs from its plain version")
    state = [t.clone() for t in (dm0, c0, hid0)]
    run = lambda: lp.lstm_pointwise_step(state[0], y,  # noqa: E731
                                         *state[1:], active)
    glue_state = [t.clone() for t in (dm0, c0, hid0)]
    plain_state = [t.clone() for t in (dm0, c0, hid0)]

    def glue():
        # the launches the engine made around the old kernel
        dm, c, hid = glue_state
        dm_new = dm + y
        c.copy_(torch.where(am, want_state[1], c))
        hid.copy_(torch.where(am, want, hid))
        dm.copy_(torch.where(am, dm_new, dm))

    library_ms = library_device_ms = None
    if hasattr(torch.ops.aten, "_thnn_fused_lstm_cell"):
        # PyTorch's fused LSTM cell (gate order i, f, g, o) adds its two
        # gate inputs, as the step adds y to dm; the reorder happens
        # outside the timed call
        fused = torch.ops.aten._thnn_fused_lstm_cell
        order = [0, 2, 1, 3]
        gates_dm, gates_y = (
            t.view(b, 4, h_dim)[:, order].reshape(b, -1).contiguous()
            for t in (dm0, y))
        check(max_err(fused(gates_dm, gates_y, c0)[0], want) <= 1e-5,
              "library LSTM cell disagrees with the plain version")
        library_ms = time_ms(torch, lambda: fused(gates_dm, gates_y, c0))
        library_device_ms = device_ms(
            torch, lambda: fused(gates_dm, gates_y, c0), "")
    return {
        "case": f"step B={b} H={h_dim} active={n_active}",
        "max_abs_err": max(max_err(u, v) for u, v in
                           zip([got, *got_state], [want, *want_state])),
        "ms": time_ms(torch, run),
        "kernel_device_ms": device_ms(torch, run, "lstm_pointwise_kernel"),
        "plain_ms": time_ms(torch, lambda: lp.plain_step(
            plain_state[0], y, *plain_state[1:], active)),
        "glue_ms": time_ms(torch, glue),
        "glue_device_ms": device_ms(torch, glue, ""),
        # dm, y, c read and h written for every row; dm, c, h written
        # for the active ones; the mask read
        "bytes": 4 * b * h_dim * 10 + 4 * n_active * h_dim * 6 + b,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
    }


def kernel_checks(torch, layers, seed: int):
    """Each kernel vs its plain version at the main path's shapes, and at
    the sharded path's (phase 9's shard batches); the batch SpMV also at
    layer 1's (Q=1147, K=573)."""
    from repro_torch.core import cbcsc_decode
    from repro_torch.kernels import delta_encode as de
    from repro_torch.kernels import lstm_pointwise as lp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import stsp_spmv as sp

    dev = layers[1].enc.val.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {}

    # delta_encode: the fused IPU stage at B=16 and at phase 9's shard
    # batches, over both layers' widths (layer 1 D=123, layer 2 D=1024;
    # H=1024), fp32 and Q8.8, 3 of every 4 slots active; then the
    # reference's call shape (the same kernel on a concatenated row, no
    # mask) at both state widths
    h_dim = 1024
    cases = []
    for b in (CAPACITY, *SHARD_BATCHES):
        active = torch.arange(b, device=dev) % 4 != 3
        n_active = int(active.sum())
        am = active[:, None]
        for d, act_bits in ((1024, None), (123, None), (1024, 16)):
            f = d + h_dim
            x = torch.randn((b, d), generator=g, device=dev)
            hid = torch.randn((b, h_dim), generator=g, device=dev)
            s_hat0 = (torch.cat([x, hid], -1)
                      + 0.3 * torch.randn((b, f), generator=g, device=dev))
            got_state, want_state = s_hat0.clone(), s_hat0.clone()
            got = de.delta_encode_step(x, hid, got_state, 0.3, active,
                                       act_bits)
            want = de.plain_step(x, hid, want_state, 0.3, active, act_bits)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                  and torch.equal(got_state, want_state),
                  f"delta_encode_step B={b} D={d} act_bits={act_bits}: "
                  f"differs from its plain version")
            state = s_hat0.clone()
            run = lambda: de.delta_encode_step(  # noqa: E731
                x, hid, state, 0.3, active, act_bits)
            # the launches the engine made around the old kernel
            glue = lambda: (torch.cat([x, hid], dim=-1),  # noqa: E731
                            state.copy_(torch.where(am, want_state, state)))
            cases.append({
                "case": f"step B={b} D={d} H={h_dim} act_bits={act_bits} "
                        f"active={n_active}",
                "max_abs_err": max(max_err(got[0], want[0]),
                                   max_err(got_state, want_state)),
                "ms": time_ms(torch, run),
                "kernel_device_ms": device_ms(torch, run,
                                              "delta_encode_kernel"),
                "plain_ms": time_ms(torch, lambda: de.plain_step(
                    x, hid, want_state, 0.3, active, act_bits)),
                "glue_ms": time_ms(torch, glue),
                "glue_device_ms": device_ms(torch, glue, ""),
                # s and s_hat read, delta and nnz written for every row,
                # s_hat for the active ones, the mask read
                "bytes": 4 * b * f * 3 + 4 * n_active * f + 5 * b,
            })
    for f, act_bits in ((1147, None), (2048, None)):
        x = torch.randn((CAPACITY, f), generator=g, device=dev)
        xh = x + 0.3 * torch.randn((CAPACITY, f), generator=g, device=dev)
        got = de.delta_encode(x, xh, 0.3, act_bits)
        want = de.plain(x, xh, 0.3, act_bits)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        check(err <= TOL_ELEMENTWISE,
              f"delta_encode F={f} act_bits={act_bits}: max err {err}")
        check(torch.equal(got[2], want[2]),
              f"delta_encode F={f} act_bits={act_bits}: fired counts differ")
        cases.append({
            "case": f"B={CAPACITY} F={f} act_bits={act_bits}",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: de.delta_encode(x, xh, 0.3,
                                                         act_bits)),
            "kernel_device_ms": device_ms(
                torch, lambda: de.delta_encode(x, xh, 0.3, act_bits),
                "delta_encode_kernel"),
            "plain_ms": time_ms(torch, lambda: de.plain(x, xh, 0.3,
                                                        act_bits)),
            "bytes": 4 * CAPACITY * f * 4 + CAPACITY * 4,
        })
    rows["delta_encode"] = dict(
        cases[0], source="src/repro_torch/kernels/csrc/spartus_kernels.cu",
        replaces="src/repro/kernels/delta_encode.py:48", library_ms=None,
        library_device_ms=None, cases=cases)

    # lstm_pointwise: the fused accumulate + HPE stage at B=16 and at
    # phase 9's shard batches, H=1024, 3 of every 4 slots active (y
    # small, so the delta memories stay in range over the timed calls);
    # then the reference's call shape [16, 4, 1024]
    cases = []
    for b in (CAPACITY, *SHARD_BATCHES):
        cases.append(pointwise_step_case(torch, lp, g, dev, b, h_dim))
    dm = torch.randn((CAPACITY, 4, h_dim), generator=g, device=dev)
    c = torch.randn((CAPACITY, h_dim), generator=g, device=dev)
    got, want = lp.lstm_pointwise(dm, c), lp.plain(dm, c)
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    check(err <= TOL_ELEMENTWISE, f"lstm_pointwise: max err {err}")
    cases.append({
        "case": f"B={CAPACITY} H={h_dim}", "max_abs_err": err,
        "ms": time_ms(torch, lambda: lp.lstm_pointwise(dm, c)),
        "kernel_device_ms": device_ms(torch, lambda: lp.lstm_pointwise(dm, c),
                                      "lstm_pointwise_kernel"),
        "plain_ms": time_ms(torch, lambda: lp.plain(dm, c)),
        "bytes": (CAPACITY * 5 * h_dim + 2 * CAPACITY * h_dim) * 4,
    })
    rows["lstm_pointwise"] = dict(
        cases[0], source="src/repro_torch/kernels/csrc/spartus_kernels.cu",
        replaces="src/repro/kernels/lstm_pointwise.py:33", cases=cases)

    # the CBCSC SpMV on the packed full-width layers, NZI lists built by
    # the serving CTRL stage from deltas with ~30% of the columns fired:
    # layer 2 (Q=2048, K=1024) at B=16 and B=1, layer 1 (Q=1147, K=573)
    # at B=16 and both layers at phase 9's shard batches as the batch
    # kernel's extra cases
    def spmv_cases(layer, name, b):
        enc, s = layer.enc, layer.enc.s
        q, m, blen = enc.val.shape
        fired = torch.rand((CAPACITY, q), generator=g, device=dev) < 0.3
        delta = torch.where(fired, torch.randn((CAPACITY, q), generator=g,
                                               device=dev), 0.0)
        idx, ds, _ = ops.select_active_columns_batch(delta, layer.capacity)
        ii, dd = idx[:b].contiguous(), ds[:b].contiguous()
        k = ii.shape[1]
        val8 = torch.round(enc.val / layer.scale).to(torch.int8)
        lidx8 = enc.lidx.to(torch.int8)
        w_csr = cbcsc_decode(enc, torch.float32).to_sparse_csr()
        dense_ds = torch.zeros((q, b), device=dev)
        dense_ds.scatter_add_(0, ii.long().T, dd.T)
        library = lambda: torch.sparse.mm(w_csr, dense_ds)  # noqa: E731
        check(max_err(library().T, ref.stsp_spmv_scatter_batch_ref(
            enc.val, enc.lidx, ii, dd, s)) <= TOL_SPMV,
            f"{name}: library sparse product disagrees")
        lib_ms = time_ms(torch, library)
        lib_device_ms = device_ms(torch, library, "")
        # bytes the product must move: the NZI lists, once the slab of
        # every column active in any slot (the slots share one weight
        # set) and the output
        n_cols = torch.unique(ii[dd != 0]).numel()
        cases = []
        for label, v, l, sc in (("fp32", enc.val, enc.lidx, 1.0),
                                ("int8", val8, lidx8, float(layer.scale))):
            if b == 1:
                run = lambda: sp.stsp_spmv(v, l, ii[0], dd[0], s=s)[None]
                plain = lambda: sp.plain(v, l, ii[0], dd[0], s)[None]
            else:
                run = lambda: sp.stsp_spmv_scatter_batch(v, l, ii, dd, s=s)
                plain = lambda: sp.plain_batch(v, l, ii, dd, s)
            got = run()
            # the plain scatter on the host adds each row's terms in list
            # order, as the kernel does: bit-identical
            host = sp.plain_batch(v.cpu(), l.cpu(), ii.cpu(), dd.cpu(), s)
            check(torch.equal(got.cpu(), host),
                  f"{name} {label} B={b} K={k}: differs from the host "
                  f"scatter by {max_err(got.cpu(), host)}")
            # the card's plain versions sum in another order (atomic
            # scatter_add, or the one-hot einsum at B=1); int8 payloads
            # are compared dequantized, as the SpMV epilogue consumes them
            err = max_err(got * sc, plain() * sc)
            check(err <= TOL_SPMV, f"{name} {label}: max err {err} vs the "
                                   f"plain version on the card")
            cases.append({
                "case": f"B={b} K={k} Q={q} M={m} BLEN={blen} {label}",
                "max_abs_err": max_err(got.cpu(), host),
                "card_plain_max_abs_err": err,
                "ms": time_ms(torch, run),
                "kernel_device_ms": device_ms(torch, run, "stsp_spmv_kernel"),
                "plain_ms": time_ms(torch, plain, iters=20),
                "bytes": (b * k * 8 + n_cols * m * blen * (
                    v.element_size() + l.element_size()) + b * s * m * 4),
                "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            })
        return cases

    for name, kern, b in (("stsp_spmv_scatter_batch", sp.SCATTER_BATCH_KERNEL,
                           CAPACITY), ("stsp_spmv", sp.KERNEL, 1)):
        cases = spmv_cases(layers[1], name, b)
        if b > 1:
            cases += spmv_cases(layers[0], name, b)
            # phase 9's shard batches, both layers
            for shard_b in SHARD_BATCHES:
                for layer in (layers[1], layers[0]):
                    cases += spmv_cases(layer, name, shard_b)
        check(kern.launches > 0, f"{name}: kernel was not launched")
        rows[name] = dict(
            cases[0], source="src/repro_torch/kernels/csrc/spartus_kernels.cu",
            replaces=("src/repro/kernels/stsp_spmv.py:101" if b > 1 else
                      "src/repro/kernels/stsp_spmv.py:150"),
            cases=cases)
    for row in rows.values():
        row["route"] = "cuda"
        row["bound_by"] = "bytes"
        for case in row.get("cases", []) + [row]:
            case["bound_ms"] = bound_ms(case["bytes"])
            case["bound_by"] = "bytes"
    return rows


def ulp_report(torch, got, want):
    """(elements that differ, most ulps between them) of two float32
    tensors."""
    diff = got != want
    n = int(diff.sum())
    if n == 0:
        return 0, 0
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long())
    return n, int(ulps.abs()[diff].max())


def mirror_checks(torch, params, am_cfg, seed: int):
    """The dense-mirror kernel on both layers' packed mirrors of the 2x1024
    model (fp32 and int8 packs), at each of ``MIRROR_SHARES`` of the
    deltas fired (30%, and the served model's ~5%) and at
    ``MIRROR_BATCHES`` (B = 1, phase 9's shard batches 4 and 8, 16, 32):
    ``torch.equal`` to its plain float64 product on the card (any element
    that differs fails the check, printed with its ulps), and each row
    equal to the same row computed alone.  The main row is layer 2, B=16,
    fp32 at 30% fired: the "auto" route's product; the same case at 5%
    is printed beside it."""
    from repro_torch import serving as rt
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import dense_mirror as dm

    packs = {label: rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
        theta=am_cfg.theta, gamma=GAMMA, m=M, spmv_path="dense",
        quant=quant)).layers for label, quant in (("fp32", None),
                                                  ("int8", QuantConfig()))}
    dev = packs["fp32"][0].w_dense_t.device
    # one generator per share, so each share's draws stay as they are
    gens = {share: torch.Generator(device=dev).manual_seed(seed + i)
            for i, share in enumerate(MIRROR_SHARES)}
    cases = []
    for layer_no in (2, 1):
        for label, layers in packs.items():
            layer = layers[layer_no - 1]
            wt = layer.w_dense_t
            check(wt.dtype == (torch.float32 if label == "fp32"
                               else torch.int8),
                  f"dense_mirror: the {label} pack's mirror is {wt.dtype}")
            scale = layer.scale if label == "int8" else None
            q, n = wt.shape
            for share in MIRROR_SHARES:
                g = gens[share]
                fired = torch.rand((max(MIRROR_BATCHES), q), generator=g,
                                   device=dev) < share
                ds_all = torch.where(fired, torch.randn(
                    fired.shape, generator=g, device=dev), 0.0)
                alone = torch.cat([dm.dense_mirror(ds_all[i:i + 1], wt,
                                                   scale)
                                   for i in range(ds_all.shape[0])])
                for b in MIRROR_BATCHES:
                    cases.append(mirror_case(
                        torch, ds_all[:b].contiguous(), wt, scale,
                        alone[:b], f"layer {layer_no} {label} "
                                   f"{round(share * 100)}% B={b} Q={q} "
                                   f"N={n}", label == "fp32"))
    main, served = (next(c for c in cases if c["case"].startswith(
        f"layer 2 fp32 {round(share * 100)}% B={CAPACITY} "))
        for share in MIRROR_SHARES)
    print(f"kernel dense_mirror main [{main['case']}]: kernel_device_ms "
          f"{main['kernel_device_ms']} bound_ms {main['bound_ms']:.6f} | "
          f"[{served['case']}]: kernel_device_ms "
          f"{served['kernel_device_ms']} bound_ms "
          f"{served['bound_ms']:.6f}", flush=True)
    return {"dense_mirror": dict(
        main, route="cuda",
        source="src/repro_torch/kernels/csrc/spartus_kernels.cu",
        replaces="src/repro/kernels/ops.py:341",
        note="replaces the XLA dot in delta_spmv_dense_topk_batch: a "
             "repair of the port, not the port of a TPU kernel",
        cases=cases)}


def mirror_case(torch, ds, wt, scale, alone, name: str, library: bool):
    """One dense-mirror case: the kernel ``torch.equal`` to its plain
    version and, row by row, to ``alone``; its times, and its bound from
    the work this data needs."""
    from repro_torch.kernels import dense_mirror as dm

    b, q = ds.shape
    n = wt.shape[1]
    run = lambda: dm.dense_mirror(ds, wt, scale)  # noqa: E731
    plain = lambda: dm.plain(ds, wt, scale)       # noqa: E731
    got, want = run(), plain()
    n_diff, ulps = ulp_report(torch, got, want)
    if n_diff:
        print(f"kernel dense_mirror [{name}]: {n_diff} of {got.numel()} "
              f"elements differ from the plain version, by <= {ulps} ulp",
              flush=True)
    check(n_diff == 0, f"dense_mirror {name}: {n_diff} elements differ "
                       f"from its plain version by <= {ulps} ulp")
    check(torch.equal(got, alone),
          f"dense_mirror {name}: a row differs from the same row computed "
          f"alone")
    # the work this data needs: the mirror rows of the columns fired in
    # any row, each read once; a multiply-add per fired delta and output
    # column
    touched = int((ds != 0).any(0).sum())
    n_bytes = b * q * 4 + touched * n * wt.element_size() + b * n * 4
    n_ops = 2 * int((ds != 0).sum()) * n
    bytes_ms = bound_ms(n_bytes)
    ops_ms = n_ops / FP32_FLOPS_PER_S * 1e3
    case = {
        "case": name, "max_abs_err": max_err(got, want),
        "ulp_diffs": n_diff,
        "ms": time_ms(torch, run),
        "kernel_device_ms": device_ms(torch, run, "dense_mirror_kernel"),
        "plain_ms": time_ms(torch, plain),
        "bytes": n_bytes, "ops": n_ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "library_device_ms": None,
    }
    if library:
        # cuBLAS's fp32 GEMM: not batch-invariant, never called by the port
        gemm = lambda: ds @ wt                         # noqa: E731
        case["library_ms"] = time_ms(torch, gemm)
        case["library_device_ms"] = device_ms(torch, gemm, "")
    return case


def clip_checks(torch, layers, seed: int):
    """The capacity clip kernel on both layers' Q of the 2x1024 model at
    B = 1, phase 9's shard batches, 16, 32 and the bulk bench's 1024, on
    served traffic (12% of the deltas fired, the capacity half of Q:
    nothing clipped) and on overflow (60% fired at a twentieth of Q,
    magnitudes drawn from a few values so ties straddle the threshold):
    ``ds`` and ``n_dropped`` equal to the plain version's bit for bit on
    the card and on the host.
    The main row is layer 2, B=16, served traffic; the plain version is
    the torch chain the dense route ran before the kernel."""
    from repro_torch.kernels import capacity_clip as cc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for layer_no in (2, 1):
        q = layers[layer_no - 1].input_dim + layers[layer_no - 1].hidden_dim
        for label, share, capacity in (("served 12%", 0.12, (q + 1) // 2),
                                       ("overflow 60%", 0.6, q // 20)):
            for b in (*MIRROR_BATCHES, BULK_POOL):
                tied = torch.tensor([-1.0, -0.5, 0.25, 0.5, 1.0],
                                    device=dev)[torch.randint(
                                        0, 5, (b, q), generator=g,
                                        device=dev)]
                vals = torch.where(torch.rand((b, q), generator=g,
                                              device=dev) < 0.5, tied,
                                   torch.randn((b, q), generator=g,
                                               device=dev))
                delta = torch.where(torch.rand((b, q), generator=g,
                                               device=dev) < share, vals, 0.0)
                run = lambda: cc.capacity_clip(delta, capacity)  # noqa: E731
                plain = lambda: cc.plain(delta, capacity)        # noqa: E731
                name = f"layer {layer_no} {label} B={b} Q={q}"
                got = run()
                for where, want in (("card", plain()),
                                    ("host", cc.plain(delta.cpu(),
                                                      capacity))):
                    check(torch.equal(got[0].cpu().view(torch.int32),
                                      want[0].cpu().view(torch.int32))
                          and torch.equal(got[1].cpu(), want[1].cpu()),
                          f"capacity_clip {name}: differs from the plain "
                          f"version on the {where}")
                n_bytes = 2 * b * q * 4 + b * 4
                cases.append({
                    "case": name, "max_abs_err": 0.0,
                    "ms": time_ms(torch, run),
                    "kernel_device_ms": device_ms(torch, run,
                                                  "capacity_clip_topk"),
                    "plain_ms": time_ms(torch, plain, iters=20),
                    "plain_device_ms": device_ms(torch, plain, ""),
                    "bytes": n_bytes, "bound_ms": bound_ms(n_bytes),
                    "bound_by": "bytes",
                    "library_ms": None, "library_device_ms": None,
                })
    check(cc.KERNEL.launches > 0, "capacity_clip: kernel was not launched")
    main = next(c for c in cases
                if c["case"].startswith(f"layer 2 served 12% B={CAPACITY} "))
    print(f"kernel capacity_clip main [{main['case']}]: kernel_device_ms "
          f"{main['kernel_device_ms']} plain_device_ms "
          f"{main['plain_device_ms']} bound_ms {main['bound_ms']:.6f}",
          flush=True)
    return {"capacity_clip": dict(
        main, route="cuda",
        source="src/repro_torch/kernels/csrc/spartus_kernels.cu",
        replaces="src/repro/kernels/ops.py:380",
        note="replaces the count and the lax.cond-guarded top_k clip in "
             "delta_spmv_dense_topk_batch, which the port ran as a chain "
             "of PyTorch calls: not the port of a TPU kernel",
        cases=cases)}


# -- phase 3: serving at full width -----------------------------------------


def make_requests(rt, am_cfg, rng):
    """N_REQUESTS utterances of MIN_FRAMES..MAX_FRAMES seeded normal
    frames, all arriving at step 0."""
    return [
        rt.StreamRequest(req_id=i, arrival_step=0, feats=rng.standard_normal(
            (int(rng.integers(MIN_FRAMES, MAX_FRAMES + 1)),
             am_cfg.input_dim)).astype(np.float32))
        for i in range(N_REQUESTS)]


def serving_runs(torch, params, am_cfg, rng, out_dir: Path):
    from repro_torch import serving as rt
    from repro_torch.core import QuantConfig

    counters = kernel_counters()
    requests = make_requests(rt, am_cfg, rng)
    cpu_requests = [rt.StreamRequest(r.req_id, 0,
                                     r.feats[:CPU_CHECK_FRAMES])
                    for r in requests[:CPU_CHECK_REQUESTS]]
    warm_requests = [rt.StreamRequest(r.req_id, 0, r.feats[:2 * CHUNK_FRAMES])
                     for r in requests[:CAPACITY]]
    launches = {path: {name: 0 for name in counters}
                for path in ("pool", "batch1")}

    report = []
    for route, quant in (("auto", None), ("scatter", None),
                         ("scatter", QuantConfig())):
        label = route + ("+int8" if quant else "")
        ecfg = rt.EngineConfig(theta=am_cfg.theta, gamma=GAMMA, m=M,
                               spmv_path=route, quant=quant)
        engine = rt.BatchedSpartusEngine(params, am_cfg, ecfg)
        batch1 = rt.SpartusEngine(params, am_cfg, ecfg)
        dense = [l.w_dense_t is not None for l in engine.layers]
        # one short untimed wave first, so that no route's timed run pays
        # the process's one-off set-up (allocator growth, library handles)
        rt.serve_requests(engine, warm_requests, CAPACITY,
                          chunk_frames=CHUNK_FRAMES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        t0 = time.perf_counter()
        results, stats = rt.serve_requests(engine, requests, CAPACITY,
                                           chunk_frames=CHUNK_FRAMES)
        wall = time.perf_counter() - t0
        counts = {"pool": read_counts(torch, counters)}
        peak = torch.cuda.max_memory_allocated()
        zero_counts(counters)
        b1 = [batch1.run_utterance(requests[i].feats).cpu().numpy()
              for i in range(2)]
        counts["batch1"] = read_counts(torch, counters)
        for path, by_name in counts.items():
            for name, n in by_name.items():
                launches[path][name] += n
        check(len(results) == N_REQUESTS and not stats.truncated,
              f"{label}: {len(results)} of {N_REQUESTS} requests served")
        for r, req in zip(results, requests):
            check(r.logits.shape == (req.n_frames, am_cfg.n_classes)
                  and np.isfinite(r.logits).all(),
                  f"{label}: request {r.req_id} logits malformed")
        check(all(np.abs(np.diff(r.logits, axis=0)).max() > 0
                  for r in results),
              f"{label}: some request's logits never change over time")
        err_b1 = max(float(np.abs(results[i].logits - b1[i]).max())
                     for i in range(2))
        check(err_b1 <= TOL_POOL_VS_BATCH1,
              f"{label}: pool vs batch-1 max err {err_b1}")
        spmv = {"pool": "stsp_spmv_scatter_batch", "batch1": "stsp_spmv"}
        for path, by_name in counts.items():
            need = ["delta_encode", "lstm_pointwise"]
            if not all(dense):
                need.append(spmv[path])
            if any(dense):
                need += ["dense_mirror", "capacity_clip"]
            for name in need:
                check(by_name[name] > 0,
                      f"{label}: {name} never launched on the {path} path")
            for name in set(counters) - set(need):
                check(by_name[name] == 0,
                      f"{label}: {name} launched on the {path} path")

        # the card vs the same pool on the CPU (plain versions)
        gpu_small, _ = rt.serve_requests(engine, cpu_requests, CAPACITY,
                                         chunk_frames=CHUNK_FRAMES)
        cpu_engine = rt.BatchedSpartusEngine(params, am_cfg, ecfg,
                                             device="cpu")
        cpu_small, _ = rt.serve_requests(cpu_engine, cpu_requests, CAPACITY,
                                         chunk_frames=CHUNK_FRAMES)
        err_cpu = max(float(np.abs(a.logits - b.logits).max())
                      for a, b in zip(gpu_small, cpu_small))
        check(err_cpu <= TOL_CARD_VS_CPU,
              f"{label}: card vs CPU max err {err_cpu}")
        entry = {
            "route": label, "dense_mirror_layers": dense,
            "frames": stats.total_frames, "wall_s": wall,
            "frames_per_s": stats.total_frames / wall,
            "serve_frames_per_s": stats.frames_per_s,
            "n_dispatches": stats.n_dispatches,
            "sparsity": stats.sparsity,
            "weight_payload_bytes": engine.weight_payload_bytes(),
            "max_memory_allocated": peak,
            "logits_abs_max": max(float(np.abs(r.logits).max())
                                  for r in results),
            "pool_vs_batch1_max_err": err_b1,
            "card_vs_cpu_max_err": err_cpu,
            "launches": counts,
        }
        print(f"serve {label}: {json.dumps(entry)}", flush=True)
        report.append(entry)
    (out_dir / "chip_smoke_serving.json").write_text(
        json.dumps(report, indent=1))
    return launches, requests, report


def mirror_cost(torch, params, am_cfg, requests, seed: int, out_dir: Path):
    """What the batch-invariant dense-mirror kernel costs against two
    yardsticks the port never calls, a plain fp32 ``torch.matmul`` and the
    float64 cuBLAS product the port used before it (the mirror held in
    float64 at rest in the fp32 pack, widened from int8 on every call in
    the int8 pack), and what fp32 would break.

    Op level, at layer 2's shapes (B=16, Q=2048, 4H=4096): each product's
    time and the gap between row 0 of its B=16 product and the same row
    computed alone; the whole capacity-clip + product route of the int8
    pack.  Weight memory: the bytes the fp32 pack's mirrors no longer
    take (4 a weight).  End to end: the dense route served with the
    kernel and with an fp32 matmul swapped in (runs in the order kernel,
    fp32, fp32, kernel), and the fp32 pool's gap to the fp32 batch-1
    engine; the int8 pack's dense route served, pool vs batch-1 (1e-5)."""
    from repro_torch import serving as rt
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import ops

    ecfg = rt.EngineConfig(theta=am_cfg.theta, gamma=GAMMA, m=M)
    engine = rt.BatchedSpartusEngine(params, am_cfg, ecfg)
    w32 = engine.layers[1].w_dense_t
    check(w32 is not None and w32.dtype == torch.float32,
          "the fp32 pack's layer-2 mirror is not float32")
    w64 = w32.double()
    g = torch.Generator(device=w32.device).manual_seed(seed)
    q = w32.shape[0]
    fired = torch.rand((CAPACITY, q), generator=g, device=w32.device) < 0.3
    ds = torch.where(fired, torch.randn((CAPACITY, q), generator=g,
                                        device=w32.device), 0.0)
    gemms = {
        "kernel_fp32": lambda a: ops._mirror_matmul(a, w32),
        "fp32_matmul": lambda a: a @ w32,
        "float64_at_rest": lambda a: (a.double() @ w64).float(),
        "float64_widened_per_call": lambda a: (a.double()
                                               @ w32.double()).float(),
    }
    qcfg = rt.EngineConfig(theta=am_cfg.theta, gamma=GAMMA, m=M,
                           quant=QuantConfig())
    qengine = rt.BatchedSpartusEngine(params, am_cfg, qcfg)
    qlayer = qengine.layers[1]
    w8, scale, cap = qlayer.w_dense_t, qlayer.scale, qlayer.capacity
    check(w8 is not None and w8.dtype == torch.int8,
          "the int8 pack's layer-2 mirror is not int8")
    gemms["kernel_int8"] = lambda a: ops._mirror_matmul(a, w8, scale)
    gemms["int8_float64_widened_per_call"] = lambda a: (
        a.double() @ w8.double()).float() * scale
    op = {}
    for name, fn in gemms.items():
        op[name] = {"ms": time_ms(torch, lambda: fn(ds)),
                    "device_ms": device_ms(torch, lambda: fn(ds), ""),
                    "row0_b16_vs_b1": max_err(fn(ds)[0], fn(ds[:1])[0])}
    op["int8_route"] = {"ms": time_ms(
        torch, lambda: ops.delta_spmv_dense_topk_batch(w8, ds, cap,
                                                       scale=scale))}
    saved = sum(4 * l.w_dense_t.numel() for l in engine.layers
                if l.w_dense_t is not None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_results, q_stats = rt.serve_requests(qengine, requests, CAPACITY,
                                           chunk_frames=CHUNK_FRAMES)
    q_wall = time.perf_counter() - t0
    q_b1 = rt.SpartusEngine(params, am_cfg, qcfg)
    q_err = max(float(np.abs(q_results[i].logits - q_b1.run_utterance(
        requests[i].feats).cpu().numpy()).max()) for i in range(2))
    check(q_err <= TOL_POOL_VS_BATCH1,
          f"int8 dense route: pool vs batch-1 max err {q_err}")
    int8_route = {"dense_mirror_layers": [l.w_dense_t is not None
                                          for l in qengine.layers],
                  "wall_s": q_wall,
                  "frames_per_s": q_stats.total_frames / q_wall,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "pool_vs_batch1_max_err": q_err}

    fp32_mirror = lambda ds_, w, scale=None: ds_ @ w     # noqa: E731
    kernel = ops._mirror_matmul

    def serve(fp32: bool):
        ops._mirror_matmul = fp32_mirror if fp32 else kernel
        try:
            eng = rt.BatchedSpartusEngine(params, am_cfg, ecfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results, stats = rt.serve_requests(eng, requests, CAPACITY,
                                               chunk_frames=CHUNK_FRAMES)
            wall = time.perf_counter() - t0
            run = {"fp32_matmul": fp32, "wall_s": wall,
                   "frames_per_s": stats.total_frames / wall,
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
            b1 = rt.SpartusEngine(params, am_cfg, ecfg)
            run["pool_vs_batch1_max_err"] = max(
                float(np.abs(results[i].logits - b1.run_utterance(
                    requests[i].feats).cpu().numpy()).max())
                for i in range(2))
            return run
        finally:
            ops._mirror_matmul = kernel

    runs = [serve(fp32) for fp32 in (False, True, True, False)]
    for run in runs:
        if not run["fp32_matmul"]:
            check(run["pool_vs_batch1_max_err"] <= TOL_POOL_VS_BATCH1,
                  f"dense route: pool vs batch-1 max err "
                  f"{run['pool_vs_batch1_max_err']}")
    report = {"op_layer2_b16": op, "fp32_pack_mirror_bytes_saved": saved,
              "serve_dense_route": runs, "serve_int8_dense_route": int8_route}
    (out_dir / "chip_smoke_mirror.json").write_text(
        json.dumps(report, indent=1))
    print(f"mirror gemm: {json.dumps(report)}", flush=True)


# device events of PyTorch's own elementwise, copy and concatenate
# kernels and of copies and fills, by name
GLUE_EVENT_NAMES = ("elementwise", "CatArray", "Memcpy", "Memset")
PROFILE_ROUTES = (("auto", False), ("scatter", False), ("scatter", True))


def profile_wave_requests(rt, requests):
    """One wave: the first CAPACITY requests cut to 64 frames."""
    return [rt.StreamRequest(r.req_id, 0, r.feats[:CPU_CHECK_FRAMES])
            for r in requests[:CAPACITY]]


def profile_wave(torch, rt, engine, wave, n_devices=None):
    """``wave`` through ``serve_requests`` once untimed, then once under
    torch.profiler: device launches per layer-frame of the pool (a
    frame-step of every slot; a sharded pool's shards each step it), all
    of them and PyTorch's elementwise/copy/cat glue apart, device busy
    time and idle share of the wall.  Returns (entry, profile)."""
    from torch.profiler import ProfilerActivity, profile

    rt.serve_requests(engine, wave, CAPACITY, chunk_frames=CHUNK_FRAMES,
                      n_devices=n_devices)
    steps = [0]
    core = rt.BatchedSpartusEngine._step_core

    def counted(self, *args, **kwargs):
        steps[0] += 1
        return core(self, *args, **kwargs)

    rt.BatchedSpartusEngine._step_core = counted
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.serve_requests(engine, wave, CAPACITY,
                              chunk_frames=CHUNK_FRAMES, n_devices=n_devices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rt.BatchedSpartusEngine._step_core = core
    from repro_torch.serving import sharding as shardlib

    n_shards = shardlib.n_pool_shards(
        shardlib.make_pool_mesh(n_devices, engine.device), CAPACITY)
    # device events only: the CUDA runtime's host-side calls
    # (cudaLaunchKernel, cudaMemcpyAsync, ...) appear too, with no
    # device time of their own
    kernels = sorted(((e.key, self_device_us(e) / 1e6, e.count)
                      for e in prof.key_averages()
                      if self_device_us(e) > 0), key=lambda r: -r[1])
    busy = sum(t for _, t, _ in kernels)
    launches = sum(n for _, _, n in kernels)
    glue = sum(n for k, _, n in kernels
               if any(name in k for name in GLUE_EVENT_NAMES))
    frame_steps = steps[0] // n_shards
    layer_frames = frame_steps * len(engine.layers)
    return {"frames": CAPACITY * CPU_CHECK_FRAMES, "n_shards": n_shards,
            "frame_steps": frame_steps, "layer_frames": layer_frames,
            "device_launches": launches, "glue_launches": glue,
            "launches_per_layer_frame": launches / layer_frames,
            "glue_launches_per_layer_frame": glue / layer_frames,
            "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "by_kernel": [{"name": k[:90], "device_s": t, "count": n}
                          for k, t, n in kernels[:15]]}, prof


def profile_serving(torch, params, am_cfg, requests, out_dir: Path):
    """One wave (16 requests cut to 64 frames) of each route, under
    torch.profiler: device launches per layer-frame (all of them, and
    PyTorch's elementwise/copy/cat glue apart), device busy time and idle
    share of the wall time, and, on the scatter route, the SpMV's device
    time split by layer (each frame-step launches layer 1's SpMV, then
    layer 2's).  Returns the report, one entry per route."""
    from repro_torch import serving as rt
    from repro_torch.core import QuantConfig

    wave = profile_wave_requests(rt, requests)
    report = []
    for route, quant in PROFILE_ROUTES:
        engine = rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
            theta=am_cfg.theta, gamma=GAMMA, m=M, spmv_path=route,
            quant=QuantConfig() if quant else None))
        entry, prof = profile_wave(torch, rt, engine, wave)
        entry = dict(route=route + ("+int8" if quant else ""), **entry)
        wall, busy = entry["wall_s"], entry["device_busy_s"]
        layer_frames = entry["layer_frames"]
        if route == "scatter" and not quant:
            spmv = sorted((e for e in prof.events()
                           if "stsp_spmv_kernel" in e.name),
                          key=lambda e: e.time_range.start)
            entry["spmv_by_layer"] = []
            for layer in (0, 1):
                evts = spmv[layer::2]
                total = sum(e.time_range.elapsed_us() for e in evts) / 1e6
                entry["spmv_by_layer"].append({
                    "layer": layer + 1, "launches": len(evts),
                    "device_s": total,
                    "mean_ms": total / len(evts) * 1e3 if evts else None})
        report.append(entry)
        print(f"profile {entry['route']}: wall_s {wall:.4f} device_busy_s "
              f"{busy:.4f} idle_share {entry['device_idle_share']} "
              f"launches/layer-frame {entry['launches_per_layer_frame']:.2f}"
              f" (glue {entry['glue_launches_per_layer_frame']:.2f}) over "
              f"{layer_frames} layer-frames", flush=True)
        if "spmv_by_layer" in entry:
            print(f"  spmv by layer: {json.dumps(entry['spmv_by_layer'])}",
                  flush=True)
        for row in entry["by_kernel"][:8]:
            print(f"  {row['device_s']:.5f} s  x{row['count']}  "
                  f"{row['name']}", flush=True)
    if out_dir is not None:
        (out_dir / "chip_smoke_profile.json").write_text(
            json.dumps(report, indent=1))
    return report


# -- phase 4: the streaming front-end at full width --------------------------


def make_stream_clients(am_cfg, rng):
    """N_STREAM_CLIENTS seeded utterances of MIN_FRAMES..MAX_FRAMES
    frames, each cut into blocks of 1..MAX_BLOCK frames sent with seeded
    gaps after a staggered start; two clients cancel halfway, one is the
    slow consumer."""
    clients = []
    for i in range(N_STREAM_CLIENTS):
        t = int(rng.integers(MIN_FRAMES, MAX_FRAMES + 1))
        feats = rng.standard_normal((t, am_cfg.input_dim)).astype(np.float32)
        cuts = [0]
        while cuts[-1] < t:
            cuts.append(min(t, cuts[-1] + int(rng.integers(1, MAX_BLOCK + 1))))
        blocks = list(zip(cuts[:-1], cuts[1:]))
        clients.append({
            "id": i, "feats": feats, "blocks": blocks,
            "gaps": rng.uniform(0.0, 0.004, len(blocks)).tolist(),
            "start": float(rng.uniform(0.0, 0.25)),
            "cancel_at": (len(blocks) // 2 if i in CANCELLED_CLIENTS
                          else None),
            "slow": i == SLOW_CLIENT,
        })
    return clients


async def stream_client(srv, c):
    """One client: feeds its blocks, consumes partials as they come (the
    slow consumer takes two blocks halfway and the rest at the end) and
    returns its partials and result, or ``cancelled``."""
    await asyncio.sleep(c["start"])
    h = await srv.stream(want_partials=True)
    parts = []

    async def consume():
        async for p in h:
            parts.append(p)

    consumer = None if c["slow"] else asyncio.create_task(consume())
    for b, (lo, hi) in enumerate(c["blocks"]):
        if b == c["cancel_at"]:
            h.cancel()
            try:
                await h.result()
            except asyncio.CancelledError:
                pass
            else:
                raise SmokeFailure(f"client {c['id']}: result after cancel")
            if consumer is not None:
                await consumer
            return {"cancelled": True, "parts": parts}
        await h.send(c["feats"][lo:hi])
        if c["slow"] and b == len(c["blocks"]) // 2:
            for _ in range(2):
                parts.append(await asyncio.wait_for(h.__anext__(), 120))
        await asyncio.sleep(c["gaps"][b])
    h.close()
    result = await h.result()
    if consumer is not None:
        await consumer
    else:
        parts += [p async for p in h]
    return {"cancelled": False, "parts": parts, "result": result}


def instrument(torch, pool, engine, call: str = "tick"):
    """Time each dispatching ``pool.<call>`` (``tick``, or ``step_chunk``
    for a tree without ``tick``) without adding a sync: its host wall
    time; inside it, the engine's ``step_chunk`` (the host time of the
    launches, and CUDA events around them: the chunk's device span), the
    pool's ``_resolve`` (the wait on the previous chunk's staged copies)
    and its ``_fold_boundary`` where it has one (the observability fold).
    ``read()`` after the run returns the per-call samples."""
    timing = {"wall_ms": [], "dispatch_ms": [], "resolve_ms": [],
              "fold_ms": [], "events": []}
    cur = {}
    outer = getattr(pool, call)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            cur[name] = cur.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    def timed_call(*args, **kwargs):
        cur.clear()
        t0 = time.perf_counter()
        out = outer(*args, **kwargs)
        if "events" in cur:                  # it dispatched a chunk
            timing["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            for name in ("dispatch_ms", "resolve_ms", "fold_ms"):
                if name in cur:
                    timing[name].append(cur[name])
            timing["events"].append(cur["events"])
        return out

    # a sharded pool calls every shard's engine replica once per dispatch:
    # the dispatch's host time sums them, and its device span is the
    # longest of its cards' spans (first shard's start to last shard's end
    # on each card)
    engines = list({id(e): e for e in (
        [sh.engine for sh in pool._shards] if hasattr(pool, "_shards")
        else [engine])}.values())

    def timed_chunk_of(eng):
        step_chunk = eng.step_chunk

        def timed_chunk(*args, **kwargs):
            stream = torch.cuda.current_stream(eng.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            t0 = time.perf_counter()
            out = step_chunk(*args, **kwargs)
            cur["dispatch_ms"] = (cur.get("dispatch_ms", 0.0)
                                  + (time.perf_counter() - t0) * 1e3)
            end.record(stream)
            spans = cur.setdefault("events", {})
            first = spans.get(stream.device, (start, end))[0]
            spans[stream.device] = (first, end)
            return out

        return timed_chunk

    setattr(pool, call, timed_call)
    pool._resolve = timed("resolve_ms", pool._resolve)
    if hasattr(pool, "_fold_boundary"):
        pool._fold_boundary = timed("fold_ms", pool._fold_boundary)
    for eng in engines:
        eng.step_chunk = timed_chunk_of(eng)

    def read():
        for eng in engines:
            del eng.step_chunk
            torch.cuda.synchronize(eng.device)
        out = {k: v for k, v in timing.items() if k != "events"}
        out["chunk_device_span_ms"] = [
            max(a.elapsed_time(b) for a, b in spans.values())
            for spans in timing["events"]]
        return out

    return read


def summary(values):
    arr = np.asarray(values, np.float64)
    if not arr.size:
        return None
    return {"n": int(arr.size), "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max())}


async def admin_scrape(start_admin_server, srv, obs):
    """Query the admin endpoint's four commands while clients stream."""
    admin = await start_admin_server(srv, obs, port=0)
    port = admin.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    replies = {}
    for cmd in ({"cmd": "healthz"}, {"cmd": "stats"}, {"cmd": "metrics"},
                {"cmd": "timeseries", "last": 8}):
        writer.write((json.dumps(cmd) + "\n").encode())
        await writer.drain()
        replies[cmd["cmd"]] = json.loads(await reader.readline())
    writer.close()
    admin.close()
    await admin.wait_closed()
    return replies


def serve_streams(torch, engine, clients, *, faults=None, scrape=False,
                  timed=False, n_devices=None):
    """One run of every client through an AsyncSpartusServer.  A timed
    run is also the sync check: it runs with ``torch.cuda``'s sync debug
    mode set to "error", so any blocking copy or synchronize on the
    served path, in the tick worker or on the event loop, fails it (the
    tick's waits on the previous chunk's copy events are event waits,
    which that mode allows)."""
    from repro_torch.launch.serve import start_admin_server
    from repro_torch.serving import AsyncSpartusServer, PoolObservability

    obs = PoolObservability()
    srv = AsyncSpartusServer(
        engine, CAPACITY, chunk_frames=CHUNK_FRAMES, max_frames=MAX_FRAMES,
        partial_queue_len=PARTIAL_QUEUE_LEN, offload_ticks=True,
        n_devices=n_devices, observability=obs,
        watchdog=faults is not None, faults=faults)
    read = instrument(torch, srv.pool, engine) if timed else None

    async def run():
        async with srv:
            tasks = [asyncio.ensure_future(stream_client(srv, c))
                     for c in clients]
            admin = None
            if scrape:
                await asyncio.sleep(0.4)
                admin = await admin_scrape(start_admin_server, srv, obs)
            outs = await asyncio.gather(*tasks)
            return outs, admin

    t0 = time.perf_counter()
    if timed:
        torch.cuda.set_sync_debug_mode("error")
    try:
        outs, admin = asyncio.run(run())
    except RuntimeError as exc:
        if timed and "synchroniz" in str(exc):
            raise SmokeFailure(f"a device sync on the served path: {exc}")
        raise
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"outs": outs, "admin": admin, "wall": wall, "srv": srv,
            "obs": obs, "timing": read() if read else None}


def streaming_runs(torch, params, am_cfg, rng, out_dir: Path):
    """Phase 4 on both routes; returns the stream path's launch counts
    per kernel (summed over the routes) and the report."""
    from repro_torch import serving as rt

    counters = kernel_counters()
    clients = make_stream_clients(am_cfg, rng)
    warm = [dict(c, feats=c["feats"][:2 * CHUNK_FRAMES], start=0.0,
                 blocks=[(0, 2 * CHUNK_FRAMES)], gaps=[0.0], cancel_at=None,
                 slow=False) for c in clients[:CAPACITY]]
    launches = {name: 0 for name in counters}
    report = []
    for route in STREAM_ROUTES:
        engine = rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
            theta=am_cfg.theta, gamma=GAMMA, m=M, spmv_path=route))
        dense = [l.w_dense_t is not None for l in engine.layers]
        serve_streams(torch, engine, warm)            # untimed warm-up
        zero_counts(counters)
        run = serve_streams(torch, engine, clients, scrape=True, timed=True)
        counts = read_counts(torch, counters)
        for name, n in counts.items():
            launches[name] += n
        srv, outs = run["srv"], run["outs"]
        need = ["delta_encode", "lstm_pointwise"]
        if not all(dense):
            need.append("stsp_spmv_scatter_batch")
        if any(dense):
            need += ["dense_mirror", "capacity_clip"]
        for name in need:
            check(counts[name] > 0,
                  f"stream {route}: {name} never launched on the stream path")
        check(counts["stsp_spmv"] == 0,
              f"stream {route}: the batch-1 SpMV launched on the stream path")
        check(srv.pool.n_active == 0 and srv.n_connected == 0,
              f"stream {route}: the pool did not end empty")
        done_ids = {r.req_id for r in srv._completed}
        completed = {}
        for c, out in zip(clients, outs):
            if c["cancel_at"] is not None:
                check(out["cancelled"], f"stream {route}: client {c['id']} "
                                        f"was not cancelled")
                continue
            res = out["result"]
            check(res.req_id in done_ids and res.logits.shape == (
                c["feats"].shape[0], am_cfg.n_classes)
                and np.isfinite(res.logits).all(),
                f"stream {route}: client {c['id']} result malformed")
            streamed = np.concatenate([p.rows for p in out["parts"]])
            check(np.array_equal(streamed, res.logits),
                  f"stream {route}: client {c['id']} partials differ from "
                  f"its result")
            check(np.abs(np.diff(res.logits, axis=0)).max() > 0,
                  f"stream {route}: client {c['id']} logits never change")
            completed[c["id"]] = (res, out["parts"])
        check(len(done_ids) == N_STREAM_CLIENTS - len(CANCELLED_CLIENTS),
              f"stream {route}: {len(done_ids)} results, cancelled clients "
              f"must get none")
        slow_parts = completed[SLOW_CLIENT][1]
        widest = max(p.rows.shape[0] for p in slow_parts)
        check(widest > CHUNK_FRAMES,
              f"stream {route}: the slow consumer was never backfilled "
              f"(widest block {widest})")
        ids = sorted(completed)
        sync, _ = rt.serve_requests(engine, [
            rt.StreamRequest(i, 0, clients[i]["feats"]) for i in ids],
            CAPACITY, chunk_frames=CHUNK_FRAMES)
        err_sync = max(float(np.abs(completed[i][0].logits - r.logits).max())
                       for i, r in zip(ids, sync))
        check(err_sync <= TOL_POOL_VS_BATCH1,
              f"stream {route}: async vs serve_requests max err {err_sync}")
        admin = run["admin"]
        check(admin["healthz"].get("ok") is True
              and admin["healthz"]["capacity"] == CAPACITY
              and "n_dispatches" in admin["stats"]["stats"]
              and admin["metrics"]["metrics"]["spartus_dispatches_total"][
                  "value"] > 0
              and "# TYPE spartus_frames_total counter"
              in admin["metrics"]["prometheus"]
              and len(admin["timeseries"]["timeseries"]) > 0,
              f"stream {route}: admin endpoint replies malformed: "
              f"{json.dumps(admin)[:400]}")
        # one injected dispatch fault, the watchdog on: every survivor
        # equals the undisturbed run bit for bit
        from repro_torch.serving import FaultEvent, FaultInjector, FaultPlan

        inj = FaultInjector(FaultPlan(events=(FaultEvent("dispatch", 5),)))
        fault = serve_streams(torch, engine, clients, faults=inj)
        check(fault["srv"].n_recoveries == 1 and len(inj.fired) == 1,
              f"stream {route}: {fault['srv'].n_recoveries} recoveries")
        survivors = 0
        for c, out in zip(clients, fault["outs"]):
            if c["id"] in completed:
                check(not out["cancelled"] and np.array_equal(
                    out["result"].logits, completed[c["id"]][0].logits),
                    f"stream {route}: survivor {c['id']} differs from the "
                    f"undisturbed run")
                survivors += 1
        stats = srv.stats()
        timing = run["timing"]
        frames = int(sum(completed[i][0].logits.shape[0] for i in ids))
        entry = {
            "route": route, "dense_mirror_layers": dense,
            "clients": N_STREAM_CLIENTS, "completed": len(ids),
            "frames": frames, "wall_s": run["wall"],
            "frames_per_s": frames / run["wall"],
            "p50_latency_s": stats.p50_latency_s,
            "p99_latency_s": stats.p99_latency_s,
            "p50_ttfl_s": stats.p50_ttfl_s,
            "p95_queue_wait_s": stats.p95_queue_wait_s,
            "n_dispatches": stats.n_dispatches,
            "dispatches_per_frame": stats.dispatches_per_frame,
            "host_overlap_frac": stats.host_overlap_frac,
            "sync_check": "no blocking sync under sync debug mode 'error'",
            "tick_wall_ms": summary(timing["wall_ms"]),
            "dispatch_host_ms": summary(timing["dispatch_ms"]),
            "resolve_ms": summary(timing["resolve_ms"]),
            "fold_ms": summary(timing["fold_ms"]),
            "chunk_device_span_ms": summary(timing["chunk_device_span_ms"]),
            "async_vs_serve_requests_max_err": err_sync,
            "slow_consumer_widest_block": widest,
            "watchdog_recoveries": fault["srv"].n_recoveries,
            "watchdog_survivors_equal": survivors,
            "launches": counts,
        }
        print(f"stream {route}: {json.dumps(entry)}", flush=True)
        report.append(entry)
    (out_dir / "chip_smoke_stream.json").write_text(
        json.dumps(report, indent=1))
    return launches, report


# -- phase 5: training at full width -----------------------------------------


def group_sparsity(params, name: str) -> float:
    """Zero fraction over the leaves named ``name`` (``w_x``, ``w_h``:
    every LSTM layer's; ``fcl/w``)."""
    if name == "fcl/w":
        leaves = [params["fcl"]["w"]]
    else:
        leaves = [lp[name] for lp in params["lstm"]]
    zeros = sum(int((w == 0).sum()) for w in leaves)
    return zeros / sum(w.numel() for w in leaves)


def train_phase(torch, seed: int):
    """``pretrain_retrain`` of ``LSTM_2L_1024H`` into its DeltaLSTM at
    theta=0.3 (``DELTA_LSTM_2L_1024H``): CBTD gamma=0.9375, M=64, batch 16
    of 64-frame synthetic utterances, 3 pretrain epochs at delta_alpha 0.5
    (the last at alpha = 1, where the deterministic CBTD prunes) and 1
    retrain epoch.  Checks a falling loss and the pretrain's weight
    sparsity on ``w_x``, ``w_h`` and ``fcl/w``; returns the report and the
    retrained params and model config."""
    from repro_torch.configs.spartus_lstm import (
        DELTA_LSTM_2L_1024H, LSTM_2L_1024H)
    from repro_torch.data.speech import SpeechConfig
    from repro_torch.training.trainer import TrainConfig, pretrain_retrain

    cfg = TrainConfig(model=LSTM_2L_1024H,
                      data=SpeechConfig(max_frames=TRAIN_FRAMES),
                      batch_size=TRAIN_BATCH,
                      steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
                      cbtd_gamma=GAMMA, cbtd_m=M,
                      cbtd_delta_alpha=DELTA_ALPHA, seed=seed)
    pre, post, rcfg = pretrain_retrain(
        cfg, PRETRAIN_EPOCHS, RETRAIN_EPOCHS,
        theta=DELTA_LSTM_2L_1024H.theta, device="cuda")
    check(rcfg.model == DELTA_LSTM_2L_1024H,
          f"retrained into {rcfg.model}, not DELTA_LSTM_2L_1024H")
    losses = pre.losses + post.losses
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    first = float(np.mean(pre.losses[:TRAIN_STEPS_PER_EPOCH]))
    last = float(np.mean(post.losses[-TRAIN_STEPS_PER_EPOCH:]))
    check(last < first, f"training loss did not fall: {first} -> {last}")
    sparsity = {name: group_sparsity(pre.params, name)
                for name in ("w_x", "w_h", "fcl/w")}
    for name, ws in sparsity.items():
        check(abs(ws - GAMMA) <= 0.01,
              f"pretrain weight sparsity of {name} is {ws}, not {GAMMA}")
    # the first step of each phase carries one-off set-up (cuBLAS
    # handles, allocator growth): the medians leave it out
    pre_ms = float(np.median(pre.step_s[1:])) * 1e3
    post_ms = float(np.median(post.step_s[1:])) * 1e3
    report = {
        "model": cfg.model.name, "retrained": rcfg.model.name,
        "theta": rcfg.model.theta, "batch": TRAIN_BATCH,
        "frames": TRAIN_FRAMES, "steps": [pre.steps, post.steps],
        "loss_first_epoch_mean": first, "loss_last_epoch_mean": last,
        "pretrain_losses": pre.losses, "retrain_losses": post.losses,
        "pretrain_weight_sparsity": sparsity,
        "pretrain_step_ms_median": pre_ms,
        "retrain_step_ms_median": post_ms,
        "pretrain_steps_per_s": 1e3 / pre_ms,
        "retrain_steps_per_s": 1e3 / post_ms,
        "first_step_ms": [pre.step_s[0] * 1e3, post.step_s[0] * 1e3],
        "wall_s": pre.wall_s + post.wall_s,
    }
    report["step_profile"] = profile_train_steps(
        torch, post.params, {"pretrain": cfg, "retrain": rcfg})
    return report, post.params, rcfg.model


def profile_train_steps(torch, params, cfgs):
    """One ``train_step`` of each phase's config on ``params`` under
    torch.profiler, after one untimed step: the step's wall time (ending
    in the loss fetch), device busy time and idle share, device launches
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._device import upload
    from repro_torch.data.speech import SpeechDataset
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import make_train_step

    out = {}
    for label, cfg in cfgs.items():
        dev = params["fcl"]["w"].device
        batch = tuple(upload(t.numpy(), dev) for t in next(
            SpeechDataset(cfg.data, cfg.batch_size)))
        step = make_train_step(cfg)
        float(step(params, adamw_init(params), batch, 1.0)[2]["loss"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(params, adamw_init(params), batch, 1.0)[2]["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = sorted(((e.key, self_device_us(e) / 1e6, e.count)
                          for e in prof.key_averages()
                          if self_device_us(e) > 0), key=lambda r: -r[1])
        busy = sum(t for _, t, _ in kernels)
        out[label] = {
            "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_launches": sum(n for _, _, n in kernels),
            "by_kernel": [{"name": k[:90], "device_s": t, "count": n}
                          for k, t, n in kernels[:8]]}
    return out


def serve_trained(torch, params, am_cfg, requests, counters):
    """Phase 5's serving leg: the retrained weights, unscaled, through
    ``serve_requests`` on the "auto" and scatter routes (phase 3's
    requests) and one utterance through the batch-1 ``SpartusEngine`` on
    each route.  Checks pool vs batch-1 (1e-5), finite logits that are not
    all zero and change across frames, and a temporal sparsity strictly
    between 0 and 1; counts every kernel's launches over the leg."""
    from repro_torch import serving as rt

    zero_counts(counters)
    routes = []
    for route in TRAINED_ROUTES:
        ecfg = rt.EngineConfig(theta=am_cfg.theta, gamma=GAMMA, m=M,
                               spmv_path=route)
        engine = rt.BatchedSpartusEngine(params, am_cfg, ecfg)
        t0 = time.perf_counter()
        results, stats = rt.serve_requests(engine, requests, CAPACITY,
                                           chunk_frames=CHUNK_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1 = rt.SpartusEngine(params, am_cfg, ecfg).run_utterance(
            requests[0].feats).cpu().numpy()
        check(len(results) == len(requests) and not stats.truncated,
              f"trained {route}: {len(results)} of {len(requests)} served")
        for r, req in zip(results, requests):
            check(r.logits.shape == (req.n_frames, am_cfg.n_classes)
                  and np.isfinite(r.logits).all(),
                  f"trained {route}: request {r.req_id} logits malformed")
        check(all(np.abs(r.logits).max() > 0 for r in results),
              f"trained {route}: some request's logits are all zero")
        check(all(np.abs(np.diff(r.logits, axis=0)).max() > 0
                  for r in results),
              f"trained {route}: some request's logits never change")
        err_b1 = float(np.abs(results[0].logits - b1).max())
        check(err_b1 <= TOL_POOL_VS_BATCH1,
              f"trained {route}: pool vs batch-1 max err {err_b1}")
        ts = stats.sparsity["temporal_sparsity"]
        check(0.0 < ts < 1.0,
              f"trained {route}: temporal sparsity {ts} not in (0, 1)")
        routes.append({
            "route": route,
            "dense_mirror_layers": [l.w_dense_t is not None
                                    for l in engine.layers],
            "frames": stats.total_frames, "wall_s": wall,
            "frames_per_s": stats.total_frames / wall,
            "temporal_sparsity": ts,
            "capacity_overflow_rate": stats.sparsity[
                "capacity_overflow_rate"],
            "weight_sparsity": engine.weight_sparsity(),
            "pack_overflow": engine.pack_overflow_count(),
            "logits_abs_max": max(float(np.abs(r.logits).max())
                                  for r in results),
            "pool_vs_batch1_max_err": err_b1,
        })
    launches = read_counts(torch, counters)
    for name, n in launches.items():
        check(n > 0, f"trained: {name} never launched serving the trained "
                     f"weights")
    return routes, launches


def training_runs(torch, requests, random_ts, seed: int, out_dir: Path):
    """Phase 5: train at full width on the card, then serve the trained
    weights through the kernels, reporting each route's temporal sparsity
    beside the one phase 3's scaled random network reached on it
    (``random_ts``, by route).  Returns the launches per kernel."""
    counters = kernel_counters()
    report, params, am_cfg = train_phase(torch, seed)
    report["device"] = nvidia_smi()
    brief = {k: v for k, v in report.items() if not k.endswith("_losses")}
    print(f"train: {json.dumps(brief)}", flush=True)
    routes, launches = serve_trained(torch, params, am_cfg, requests,
                                     counters)
    for entry in routes:
        entry["random_net_temporal_sparsity"] = random_ts.get(entry["route"])
        print(f"trained serve {entry['route']}: {json.dumps(entry)}",
              flush=True)
    report.update(serving=routes, launches=launches)
    (out_dir / "chip_smoke_train.json").write_text(json.dumps(report,
                                                              indent=1))
    return launches


# -- phase 6: hot-path contracts, DeltaGRU / DeltaLinear, an example ---------


def contract_checks(torch, out_dir: Path):
    """Every contract case (``repro_torch.analysis.cases``: the reference's
    14, its sharded case and the served routes at the served NZI
    capacity) on the card at
    test scale and at the 2x1024 model's full width (capacity 16, 16-frame
    chunks), each traced call under sync debug mode "error"; fails on any
    violation.  Returns the kernels' launches over the checks."""
    from repro_torch.analysis import cases, contracts

    counters = kernel_counters()
    zero_counts(counters)
    reports = []
    for width in ("test", "full"):
        for case in (cases.build_cases(width=width, device="cuda")
                     + cases.served_cases(width=width, device="cuda")):
            built = case.build()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                report = contracts.check_built(case, built)
            except RuntimeError as exc:
                raise SmokeFailure(f"contract case {width} {case.name}: a "
                                   f"device sync on its call: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            reports.append(dict(report.to_dict(), width=width))
    launches = read_counts(torch, counters)
    violations = [dict(v, case=r["case"], width=r["width"])
                  for r in reports for v in r["violations"]]
    summary_line = {"cases": len(reports), "violations": len(violations),
                    "by_width": {w: sum(r["width"] == w for r in reports)
                                 for w in ("test", "full")},
                    "launches": launches}
    (out_dir / "chip_smoke_contracts.json").write_text(
        json.dumps(reports, indent=1))
    print(f"contracts: {json.dumps(summary_line)}", flush=True)
    check(not violations, f"contract violations on the card: {violations}")
    return launches


def delta_rnn_checks(torch, seed: int):
    """DeltaGRU and DeltaLinear at H=1024, D=123 over 64 frames of a
    smooth seeded signal on the card against the same calls on the CPU
    (1e-4: fp32 products summed in another order, through the
    recurrence), with the fired counts equal; DeltaGRU at theta 0 against
    the plain GRU on the card (1e-4)."""
    from repro_torch import core

    d, h, t, theta = 123, 1024, 64, 0.1
    rng = np.random.default_rng(seed)
    xs = np.zeros((t, d), np.float32)
    xs[0] = rng.standard_normal(d)
    for i in range(1, t):
        xs[i] = 0.9 * xs[i - 1] + 0.1 * rng.standard_normal(d)
    host = core.init_gru_params(torch.Generator().manual_seed(seed), d, h)
    host["b_x"] = 0.1 * torch.randn((3, h),
                                    generator=torch.Generator().manual_seed(1))
    card = {k: v.cuda() for k, v in host.items()}
    x_host = torch.from_numpy(xs)
    x_card = x_host.cuda()
    report = {}
    t0 = time.perf_counter()
    hs_c, st_c, aux_c = core.delta_gru_layer(card, x_card, theta)
    torch.cuda.synchronize()
    report["delta_gru_card_s"] = time.perf_counter() - t0
    hs_h, st_h, aux_h = core.delta_gru_layer(host, x_host, theta)
    report["delta_gru_card_vs_cpu"] = max(
        [max_err(hs_c.cpu(), hs_h)]
        + [max_err(a.cpu(), b) for a, b in zip(st_c, st_h)])
    check(report["delta_gru_card_vs_cpu"] <= TOL_CARD_VS_CPU,
          f"DeltaGRU card vs CPU max err {report['delta_gru_card_vs_cpu']}")
    for k in ("nnz_dx", "nnz_dh"):
        check(torch.equal(aux_c[k].cpu(), aux_h[k]),
              f"DeltaGRU {k} differs between the card and the CPU")
    report["delta_gru_temporal_sparsity_dx"] = 1.0 - float(
        aux_c["nnz_dx"].float().mean()) / d
    hs0, _, _ = core.delta_gru_layer(card, x_card, 0.0)
    report["delta_gru_theta0_vs_gru"] = max_err(hs0,
                                                core.gru_layer(card, x_card))
    check(report["delta_gru_theta0_vs_gru"] <= TOL_CARD_VS_CPU,
          f"DeltaGRU at theta 0 vs the GRU: "
          f"{report['delta_gru_theta0_vs_gru']}")

    gen = torch.Generator().manual_seed(seed + 2)
    w = torch.randn((4 * h, d), generator=gen) / d ** 0.5
    bias = torch.randn((4 * h,), generator=gen)
    ys_c, st_c, aux_c = core.delta_linear_over_time(w.cuda(), x_card, theta,
                                                    bias=bias.cuda())
    ys_h, st_h, aux_h = core.delta_linear_over_time(w, x_host, theta,
                                                    bias=bias)
    report["delta_linear_card_vs_cpu"] = max(max_err(ys_c.cpu(), ys_h),
                                             max_err(st_c.y.cpu(), st_h.y))
    check(report["delta_linear_card_vs_cpu"] <= TOL_CARD_VS_CPU,
          f"DeltaLinear card vs CPU max err "
          f"{report['delta_linear_card_vs_cpu']}")
    check(torch.equal(aux_c["nnz_dx"].cpu(), aux_h["nnz_dx"]),
          "DeltaLinear nnz_dx differs between the card and the CPU")
    print(f"delta rnn: {json.dumps(report)}", flush=True)
    return report


def transformer_example(torch):
    """``python -m repro_torch.examples.delta_transformer_decode`` at its
    published sizes on the card: speech-like inputs sparser than text at
    every threshold above 0, the dense product at theta 0."""
    from repro_torch.examples import delta_transformer_decode as ex

    rows = ex.main([])
    torch.cuda.synchronize()
    check(rows[0]["max_err"] <= 1e-3,
          f"DeltaLinear at theta 0 departs from the dense product by "
          f"{rows[0]['max_err']}")
    check(all(r["speech_ts"] > r["text_ts"] for r in rows[1:]),
          f"speech-like inputs not sparser than text: {rows}")
    print(f"example delta_transformer_decode: {json.dumps(rows)}",
          flush=True)
    return rows


# -- phase 7: the model zoo ----------------------------------------------------


def zoo_logits(cfg, params, x, toks=None):
    """The family's teacher-forced logits [B, S, V] over ``x`` (tokens;
    embeddings for vlm; encoder frames for audio, whose decoder reads
    ``toks``)."""
    from repro_torch.models import encdec, mamba2, rglru, transformer

    if cfg.family in ("dense", "moe"):
        return transformer.forward(params, cfg, x)
    if cfg.family == "vlm":
        return transformer.forward(params, cfg, None, inputs_embeds=x)
    if cfg.family == "ssm":
        return mamba2.forward(params, cfg, x)
    if cfg.family == "hybrid":
        return rglru.forward(params, cfg, x)
    return encdec.decode_train(params, cfg, toks,
                               encdec.encode(params, cfg, x))


def zoo_inputs(torch, cfg, batch, seq, gen):
    """Seeded inputs of ``zoo_logits`` and of ``seq`` decode steps, on the
    generator's device: (x, decoder tokens or None, step inputs)."""
    dev = gen.device
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    if cfg.family == "vlm":
        x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
        return x, None, [x[:, i:i + 1] for i in range(seq)]
    steps = [toks[:, i:i + 1] for i in range(seq)]
    if cfg.family == "audio":
        frames = torch.randn((batch, ZOO_ENC_FRAMES, cfg.d_model),
                             generator=gen, device=dev)
        return frames, toks, steps
    return toks, None, steps


def zoo_decode(torch, cfg, params, cache, steps):
    """Logits [B, n, V] of decode steps fed ``steps`` in turn."""
    from repro_torch.models import api

    outs = []
    for inp in steps:
        logits, cache = api.serve_step(params, cfg, inp, cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1), cache


def zoo_cache(cfg, params, batch, s_cache, frames, device):
    """A zero decode cache; for the audio family, the cross-KV built from
    ``frames`` (``prefill``)."""
    from repro_torch.models import api

    if cfg.family != "audio":
        return api.init_cache(cfg, batch, s_cache, device=device)
    cache = api.init_cache(cfg, batch, frames.shape[1], device=device)
    cache["cross"] = api.prefill(params, cfg, frames)
    return cache


def rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    return max_err(got.cpu(), want.cpu()) / float(want.abs().max())


class RouteRecorder:
    """Records every MoE routing decision (``layers.lax_top_k``'s input
    and chosen experts) while it is entered, in call order: one entry per
    MoE layer per call."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import layers

        self._orig = layers.lax_top_k

        def recorded(x, k):
            out = self._orig(x, k)
            self.calls.append((x.detach(), out[1].detach()))
            return out

        layers.lax_top_k = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.lax_top_k = self._orig


def routing_flips(torch, card, host, top_k):
    """Tokens routed to other experts on the card than on the host:
    ``[{"layer", "token", "gap"}]``, ``gap`` being the host's router
    probability between its k-th and (k+1)-th expert (a near-tie when
    small)."""
    flips = []
    for layer, ((_, ic), (ph, ih)) in enumerate(zip(card.calls, host.calls)):
        same = (torch.sort(ic.cpu(), -1).values
                == torch.sort(ih, -1).values).all(-1)            # [B, S]
        for b, s in (~same).nonzero().tolist():
            p = torch.sort(ph[b, s], descending=True).values
            flips.append({"layer": layer, "row": b, "token": s,
                          "gap": float(p[top_k - 1] - p[top_k])})
    return flips


def zoo_step_bytes(cfg, params, batch, experts_hit=None) -> int:
    """Weight bytes a decode step reads at least, each once: every leaf
    it uses, the embedding table only for the ``batch`` rows it gathers
    (all of it where it is also the head), no encoder weights nor the
    cross-attention's k/v projections (their product is the cached
    cross-KV), and a MoE layer's experts only those its tokens were
    routed to (``experts_hit[layer]``).  The cache is left out."""
    from repro_torch import _tree

    total = 0
    for path, leaf in _tree.leaves_with_path(params):
        n = leaf.numel() * leaf.element_size()
        if path == "embed" and not cfg.tie_embeddings:
            n = batch * cfg.d_model * leaf.element_size()
        elif path.startswith(("enc_layers", "enc_norm",
                              "dec_layers/cross_attn/k",
                              "dec_layers/cross_attn/v")):
            n = 0
        elif experts_hit is not None and path.startswith(
                ("layers/moe/gate", "layers/moe/up", "layers/moe/down")):
            per_expert = n // (cfg.n_layers * cfg.n_experts)
            n = per_expert * sum(experts_hit)
        total += n
    return total


def zoo_serve(torch, cfg, params, seed):
    """``serve_arch``'s loop at full width: B=4, a 128-slot cache, one
    warm-up step, then 32 greedy steps timed (host clock, ending in a
    sync; torch's sync debug mode at "error", so a step that waits on the
    card fails); then one more step under torch.profiler (device
    launches, busy share, the kernels that take the most device time)
    and one with its routing recorded (the experts a MoE step reads).
    Checks finite logits that change across steps."""
    from repro_torch.models import api

    dev = params["embed"].device
    cache = api.init_cache(cfg, ZOO_BATCH, ZOO_CTX, device=dev)
    toks = torch.zeros((ZOO_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, cache = api.serve_step(params, cfg, toks, cache)
        torch.cuda.synchronize()
        outs = []
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(ZOO_STEPS):
                logits, cache = api.serve_step(params, cfg, toks, cache)
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
                outs.append(logits[:, 0])
        except RuntimeError as exc:
            raise SmokeFailure(f"{cfg.name}: a device sync in a decode "
                               f"step: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / ZOO_STEPS
        prof = profile_step(torch, lambda: api.serve_step(params, cfg, toks,
                                                          cache))
        with RouteRecorder() as rec:
            api.serve_step(params, cfg, toks, cache)
    outs = torch.stack(outs, 1)
    check(bool(torch.isfinite(outs).all()),
          f"{cfg.name}: non-finite logits in decode")
    spread = float((outs - outs[:, :1]).abs().max())
    check(spread > 0, f"{cfg.name}: logits constant across {ZOO_STEPS} steps")
    hit = ([int(ids.unique().numel()) for _, ids in rec.calls]
           if cfg.family == "moe" else None)
    n_bytes = zoo_step_bytes(cfg, params, ZOO_BATCH, hit)
    return {"ms_per_token": dt * 1e3, "tok_per_s": ZOO_BATCH / dt, **prof,
            "step_bytes": n_bytes, "bound_ms": bound_ms(n_bytes),
            "experts_hit_per_layer": hit,
            "logit_spread_across_steps": spread}


def zoo_decode_vs_forward(torch, cfg, params, seed):
    """The reference test's gate (``tests/test_arch_smoke.py``): decode
    stepped over 8 tokens at B=1 against the teacher-forced forward
    (audio: ``decode_train`` against stepped ``decode_step`` on
    ``build_cross_cache``), rtol 2e-2, atol 2e-3.  Returns max|diff|."""
    dev = params["embed"].device
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.inference_mode():
        x, toks, steps = zoo_inputs(torch, cfg, 1, ZOO_CHECK_TOKENS, gen)
        full = zoo_logits(cfg, params, x, toks)
        cache = zoo_cache(cfg, params, 1, ZOO_CHECK_TOKENS,
                          x if cfg.family == "audio" else None, dev)
        stepped, _ = zoo_decode(torch, cfg, params, cache, steps)
    check(torch.allclose(stepped, full, rtol=ZOO_DECODE_RTOL,
                         atol=ZOO_DECODE_ATOL),
          f"{cfg.name}: decode departs from the forward by "
          f"{max_err(stepped, full)}")
    return max_err(stepped, full)


def zoo_card_vs_cpu(torch, cfg, params, seed):
    """The forward at B=1 over 8 tokens on the card against the same
    weights through the same code on the CPU: max|diff| <= 1e-4 *
    max|logits|.  A MoE token routed to other experts on the two (a
    near-tie in the router) is reported with its layer; the gate then
    holds over the tokens before the first such token, which it cannot
    reach."""
    from repro_torch import _tree

    gen = torch.Generator(params["embed"].device).manual_seed(seed + 1)
    host = _tree.tree_map(lambda a: a.cpu(), params)
    with torch.inference_mode():
        x, toks, _ = zoo_inputs(torch, cfg, 1, ZOO_CHECK_TOKENS, gen)
        with RouteRecorder() as rc:
            got = zoo_logits(cfg, params, x, toks).cpu()
        with RouteRecorder() as rh:
            want = zoo_logits(cfg, host, x.cpu(),
                              None if toks is None else toks.cpu())
    del host
    flips = routing_flips(torch, rc, rh, cfg.top_k) if cfg.top_k else []
    for f in flips:
        print(f"zoo {cfg.name}: token {f['token']} routed apart on the card "
              f"and the host at layer {f['layer']} (router gap {f['gap']:.3g})",
              flush=True)
    upto = min([f["token"] for f in flips], default=got.shape[1])
    check(upto > 0 and all(f["gap"] <= ZOO_NEAR_TIE for f in flips),
          f"{cfg.name}: routing differs beyond a near-tie: {flips}")
    err = rel_err(got[:, :upto], want[:, :upto])
    check(err <= TOL_CARD_VS_CPU,
          f"{cfg.name}: card vs CPU {err:.3g} of max|logits|")
    return {"card_vs_cpu_rel": err, "routing_flips": flips,
            "tokens_held": upto}


def zoo_reduced_checks(torch, seed):
    """Every registry arch at ``.reduced()``: the forward over 16 tokens
    (B=2) and 8 decode steps from a 16-slot cache, on the card against
    the same seeded weights on the CPU, each within 1e-4 of max|logits|.
    Returns the largest relative difference per family."""
    from repro_torch import _tree
    from repro_torch.configs import REGISTRY
    from repro_torch.models import api

    worst = {}
    for name, full_cfg in REGISTRY.items():
        cfg = full_cfg.reduced()
        host = api.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
        card = _tree.tree_map(lambda a: a.cuda(), host)
        x, toks, steps = zoo_inputs(torch, cfg, 2, ZOO_REDUCED_TOKENS,
                                    torch.Generator().manual_seed(seed + 1))
        out = {}
        with torch.inference_mode():
            for dev, params in (("cuda", card), ("cpu", host)):
                move = (lambda a: a.to(dev)) if dev == "cuda" else (
                    lambda a: a)
                xd = move(x)
                cache = zoo_cache(cfg, params, 2, ZOO_REDUCED_TOKENS,
                                  xd if cfg.family == "audio" else None, dev)
                fwd = zoo_logits(cfg, params, xd,
                                 None if toks is None else move(toks))
                dec, _ = zoo_decode(torch, cfg, params, cache,
                                    [move(s) for s in
                                     steps[:ZOO_REDUCED_STEPS]])
                out[dev] = (fwd.cpu(), dec.cpu())
        errs = [rel_err(c, h) for c, h in zip(out["cuda"], out["cpu"])]
        check(max(errs) <= TOL_CARD_VS_CPU,
              f"{name} reduced: card vs CPU forward {errs[0]:.3g}, decode "
              f"{errs[1]:.3g} of max|logits|")
        worst[cfg.family] = max(worst.get(cfg.family, 0.0), *errs)
    return worst


def zoo_runs(torch, seed, out_dir: Path):
    """Phase 7: the four full-width models, then the ten reduced archs,
    then the launcher's ``--arch`` mode; prints one line per model and
    writes ``<out>/chip_smoke_zoo.json``."""
    from repro_torch import _tree
    from repro_torch.configs import get_arch
    from repro_torch.models import api

    report = {"full": {}}
    for name in ZOO_FULL:
        cfg = get_arch(name)
        t0 = time.perf_counter()
        params = api.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                                 device="cuda")
        torch.cuda.synchronize()
        n_params = sum(a.numel() for a in _tree.leaves(params))
        entry = {"params": n_params, "init_s": time.perf_counter() - t0}
        entry.update(zoo_serve(torch, cfg, params, seed))
        if name in ZOO_DECODE_CHECKED:
            entry["decode_vs_forward"] = zoo_decode_vs_forward(
                torch, cfg, params, seed)
        if name in ZOO_CPU_CHECKED:
            entry.update(zoo_card_vs_cpu(torch, cfg, params, seed))
        del params
        torch.cuda.empty_cache()
        report["full"][name] = entry
        print(f"zoo {name}: {n_params} params; {ZOO_STEPS} steps batch="
              f"{ZOO_BATCH} ctx {ZOO_CTX} -> {entry['ms_per_token']:.2f} "
              f"ms/token ({entry['tok_per_s']:.1f} tok/s); profiled step "
              f"{entry['profiled_step_wall_ms']:.2f} ms, "
              f"{entry['device_launches_per_step']} launches, device busy "
              f"{entry['device_busy_ms']:.3f} ms "
              f"({entry['device_busy_share']:.3f}); bound "
              f"{entry['bound_ms']:.4f} ms ({entry['step_bytes']} bytes); "
              f"decode vs forward {entry.get('decode_vs_forward')}; card vs "
              f"CPU {entry.get('card_vs_cpu_rel')}", flush=True)
        for row in entry["by_kernel"]:
            print(f"  {row['device_ms']:.4f} ms  x{row['count']}  "
                  f"{row['name']}", flush=True)
    report["reduced_card_vs_cpu_by_family"] = zoo_reduced_checks(torch, seed)
    print(f"zoo reduced card vs CPU (max rel by family): "
          f"{json.dumps(report['reduced_card_vs_cpu_by_family'])}", flush=True)
    report["launcher"] = launcher_run(ARCH_LAUNCHES)
    (out_dir / "chip_smoke_zoo.json").write_text(json.dumps(report, indent=1))
    return report


# -- phase 8: the model zoo's trainer -----------------------------------------


def zoo_train_argv(name, steps, *extra):
    """The launcher's command line for a phase-8 run of ``name``."""
    return ["--arch", name, "--steps", str(steps), "--batch",
            str(ZOO_TRAIN_BATCH), "--seq", str(ZOO_TRAIN_SEQ),
            "--cbtd-gamma", str(ZOO_TRAIN_GAMMA), "--cbtd-every",
            str(ZOO_TRAIN_EVERY), "--log-every", "1", *extra]


def run_launcher(train, argv):
    """``repro_torch.launch.train.main(argv)`` in this process, its log
    lines kept (returned beside the run) rather than printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train.main(argv)
    return run, buf.getvalue().splitlines()


class DrawRecorder:
    """Keeps the LM batch drawn at data step ``step`` (a host copy) by
    every ``LMDataset`` while it is entered."""

    def __init__(self, step: int):
        self.step, self.draws = step, []

    def __enter__(self):
        from repro_torch.data import lm

        self._orig = orig = lm.LMDataset.__next__

        def recorded(data):
            at = data.step
            out = orig(data)
            if at == self.step:
                self.draws.append(tuple(t.cpu() for t in out))
            return out

        lm.LMDataset.__next__ = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.data import lm

        lm.LMDataset.__next__ = self._orig


def train_step_flops(cfg, params, batch, seq) -> float:
    """Operations a train step needs at least: the weights' products
    (2 per multiply-add; a MoE token through its top_k experts only; the
    cross-attention's k/v over the encoder frames) and the attention
    scores and mixes (half the square where causal), forward, backward
    (twice the forward) and the remat recompute of the layer stacks.
    The SSD scan, norms and elementwise ops are left out: a lower
    bound."""
    from repro_torch import _tree

    t_in = batch * seq
    t_dec = batch * max(seq // 8, 4) if cfg.family == "audio" else t_in
    layers = head = 0.0
    for path, leaf in _tree.leaves_with_path(params):
        n = leaf.numel()
        if path == "embed":
            head += 2 * t_dec * n if cfg.tie_embeddings else 0
        elif path == "lm_head/w":
            head += 2 * t_dec * n
        elif path.endswith("/w") or path.startswith("layers/moe/"):
            tokens = (t_in if path.startswith("enc_layers") or path.startswith(
                ("dec_layers/cross_attn/k", "dec_layers/cross_attn/v"))
                else t_dec)
            if path.startswith("layers/moe/") and "router" not in path:
                n = n * cfg.top_k / cfg.n_experts
            layers += 2 * tokens * n
    h_dim = cfg.n_heads * cfg.hd
    if cfg.family in ("dense", "moe", "vlm"):
        layers += cfg.n_layers * 4 * batch * h_dim * seq * seq / 2
    elif cfg.family == "audio":
        s_dec = t_dec // batch
        layers += 4 * batch * h_dim * (cfg.n_enc_layers * seq * seq
                                       + cfg.n_dec_layers * (s_dec * s_dec / 2
                                                             + s_dec * seq))
    return 3 * (layers + head) + layers


def saved_activation_bytes(cfg, batch, seq) -> int:
    """What remat keeps between the forward and the backward: one fp32
    ``[B, S, d]`` input per layer of each stack."""
    if cfg.family == "audio":
        s_dec = max(seq // 8, 4)
        return 4 * batch * cfg.d_model * (cfg.n_enc_layers * seq
                                          + cfg.n_dec_layers * s_dec)
    return 4 * batch * seq * cfg.d_model * cfg.n_layers


def cbtd_balance(params, layout):
    """Per layout leaf, whether every subcolumn holds exactly floor(gamma
    * H / M) zeros (Alg. 1, ``effective_m``); returns the leaves that
    do not and the number checked."""
    from repro_torch import _tree
    from repro_torch.core.cbtd import drop_count, effective_m

    bad, n = [], 0
    for path, w in _tree.leaves_with_path(params):
        c = next((c for pat, c in layout.items() if pat in path), None)
        if c is None or w.ndim < 2:
            continue
        h, q = w.shape[-2:]
        m = effective_m(h, c.m)
        zeros = (w.reshape(*w.shape[:-2], h // m, m, q) == 0).sum(-3)
        if not bool((zeros == drop_count(h, m, c.gamma)).all()):
            bad.append(path)
        n += 1
    return bad, n


def zoo_train_arch(torch, name):
    """One full-width arch: step 1's gradients (every leaf nonzero but
    those named in ``ZOO_ZERO_GRAD``), one ``train_step`` under sync
    debug mode "error" with its peak memory, one profiled, the batch's
    and one prune's cost; then the launcher's run of ``ZOO_TRAIN_STEPS``
    steps, its losses falling and its last step's prune at alpha = 1
    leaving Alg. 1's exact zeros."""
    from repro_torch import _tree
    from repro_torch.configs import get_arch
    from repro_torch.core import cbtd_prune_tree
    from repro_torch.data.lm import LMConfig, LMDataset
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.training.optimizer import adamw_init

    cfg, dev = get_arch(name), torch.device("cuda")
    b, s = ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ
    args = train.parse_args(zoo_train_argv(name, ZOO_TRAIN_STEPS))
    params = api.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    opt = adamw_init(params)
    data = LMDataset(LMConfig(vocab=cfg.vocab, seq_len=s), b, device=dev)
    batch = train.next_batch(cfg, data, 0, b, s)
    n_params = sum(a.numel() for a in _tree.leaves(params))
    entry = {"params": n_params, "batch": b, "seq": s}

    _, grads = st.make_loss_and_grads(cfg, s)(params, batch)
    paths = [p for p, _ in _tree.leaves_with_path(grads)]
    norms = torch.stack([g.norm() for g in _tree.leaves(grads)]).tolist()
    del grads
    zero = [p for p, n in zip(paths, norms) if not n > 0]
    check(zero == list(ZOO_ZERO_GRAD.get(name, ())),
          f"{name}: step 1 leaves a zero gradient on {zero}")
    entry["grad_leaves_nonzero"] = len(paths) - len(zero)

    step = st.make_train_step(cfg, train.adamw_config(args), s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_in = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, metrics = step(params, opt, batch)
    except RuntimeError as exc:
        raise SmokeFailure(f"{name}: a device sync in train_step: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    state = 16 * n_params
    saved = saved_activation_bytes(cfg, b, s)
    entry.update(peak_bytes=peak, resident_before_step_bytes=state_in,
                 params_grads_m_v_bytes=state, saved_activation_bytes=saved,
                 peak_over_state_and_saved=peak / (state + saved))
    holder = {}

    def one_step():
        holder["out"] = step(params, opt, batch)

    entry.update(profile_step(torch, one_step))
    del holder
    flops = train_step_flops(cfg, params, b, s)
    n_bytes = 24 * n_params     # params, m, v read once and written once
    entry.update(step_flops=flops, step_bytes=n_bytes,
                 flop_bound_ms=flops / FP32_FLOPS_PER_S * 1e3,
                 byte_bound_ms=bound_ms(n_bytes))
    entry["bound_ms"] = max(entry["flop_bound_ms"], entry["byte_bound_ms"])
    entry["bound_by"] = ("operations" if entry["flop_bound_ms"]
                         >= entry["byte_bound_ms"] else "bytes")

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    entry["batch_source"] = ("api.make_train_batch" if cfg.family in
                             ("vlm", "audio") else "LMDataset")
    entry["batch_ms"] = float(np.median(timed(
        lambda: train.next_batch(cfg, data, 1, b, s), 3)))
    layout = train.prune_layout(cfg, ZOO_TRAIN_GAMMA)
    entry["prune_ms"] = timed(lambda: cbtd_prune_tree(params, layout, 1.0),
                              2)[-1]
    del params, opt, batch, data, step, metrics
    torch.cuda.empty_cache()

    with DrawRecorder(ZOO_RESUME_AT) as rec:
        run, log = run_launcher(train, zoo_train_argv(name, ZOO_TRAIN_STEPS))
    check(log[0].startswith(f"[train] arch={name} mesh={{'data': 1, "
                            f"'model': 1}} devices=1")
          and log[-1] == "[train] done", f"{name}: launcher log {log[:2]}")
    losses = [run.losses[i] for i in range(1, ZOO_TRAIN_STEPS + 1)]
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"{name}: loss did not fall (mean of the first 3 steps against "
          f"the last 3): {losses}")
    bad, n_leaves = cbtd_balance(run.params, layout)
    check(n_leaves > 0 and not bad,
          f"{name}: after the prune at alpha 1, {bad} lack floor(gamma H/M) "
          f"zeros in some subcolumn")
    windows = [w * 1e3 for i, w in enumerate(run.window_s_per_step, 1)
               if i > 1 and i % ZOO_TRAIN_EVERY]
    step_ms = float(np.median(windows))
    entry.update(losses=losses, first_loss=losses[0], last_loss=losses[-1],
                 step_ms=step_ms, tokens_per_s=b * s / step_ms * 1e3,
                 cbtd_leaves_balanced=n_leaves, launcher_log=log[:1] + log[-2:])
    draws = rec.draws
    del run
    torch.cuda.empty_cache()
    return entry, draws


def zoo_resume_check(torch, name, uninterrupted_draws):
    """A run of ``ZOO_RESUME_AT`` steps that checkpoints, the checkpoint
    restored (params, optimizer state and data step ``torch.equal`` to
    the run's), then the launcher resumed for one step: it picks up at
    step ``ZOO_RESUME_AT`` and draws the batch the uninterrupted run drew
    there.  The checkpoints go to ``build/zoo_train_ckpt``, removed
    after."""
    from repro_torch import _tree
    from repro_torch.launch import train
    from repro_torch.training.checkpoint import CheckpointManager

    ckpt = ROOT / "build" / "zoo_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        first, _ = run_launcher(train, zoo_train_argv(
            name, ZOO_RESUME_AT, "--ckpt-dir", str(ckpt)))
        save_s = time.perf_counter() - t0
        (params, opt), meta, at = CheckpointManager(str(ckpt)).restore_latest(
            (first.params, first.opt_state))
        check(at == ZOO_RESUME_AT and meta["data_step"] == first.data.step
              == ZOO_RESUME_AT, f"{name}: checkpoint at {at}, {meta}")
        for tree, saved in ((params, first.params), (opt, first.opt_state)):
            for (path, a), b in zip(_tree.leaves_with_path(tree),
                                    _tree.leaves(saved)):
                check(torch.equal(a, b), f"{name}: restored {path} differs")
        n_bytes = sum(a.numel() * a.element_size()
                      for a in _tree.leaves((params, opt)))
        del params, opt, first
        torch.cuda.empty_cache()
        with DrawRecorder(ZOO_RESUME_AT) as rec:
            resumed, log = run_launcher(train, zoo_train_argv(
                name, ZOO_RESUME_AT + 1, "--ckpt-dir", str(ckpt)))
        check(f"[train] resumed from step {ZOO_RESUME_AT}" in log
              and resumed.step0 == ZOO_RESUME_AT
              and resumed.data.step == ZOO_RESUME_AT + 1,
              f"{name}: resume log {log}")
        check(len(rec.draws) == 1 and len(uninterrupted_draws) == 1
              and all(torch.equal(a, b) for a, b in
                      zip(rec.draws[0], uninterrupted_draws[0])),
              f"{name}: the resumed run drew another batch at data step "
              f"{ZOO_RESUME_AT}")
        del resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"arch": name, "resumed_at": ZOO_RESUME_AT,
            "checkpoint_bytes": n_bytes, "first_run_and_save_s": save_s,
            "restored_equal": True, "same_next_batch": True}


def zoo_train_reduced_checks(torch, seed):
    """Every registry arch at ``.reduced()``: one ``make_train_step`` on
    the card against the same step on the CPU (the launcher's optimizer,
    its first batch at B=4, S=32): loss within 1e-4 relative, the
    clipped gradients (AdamW's ``m / (1 - b1)``) within 1e-4 of the
    largest, and the updated params within 1e-4 of max|param|; an element
    whose host gradient lies within twice the card-vs-host gap of zero
    may take Adam's first step the other way (up to 2 lr apart), and
    those are counted.  Returns the worst errors by family."""
    from repro_torch import _tree
    from repro_torch.configs import REGISTRY
    from repro_torch.data.lm import LMConfig, LMDataset
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.training.optimizer import adamw_init

    worst = {}
    for name, full_cfg in REGISTRY.items():
        cfg = full_cfg.reduced()
        opt_cfg = train.adamw_config(train.parse_args(
            zoo_train_argv(name, ZOO_TRAIN_STEPS)))
        host = api.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
        card = _tree.tree_map(lambda a: a.cuda(), host)
        data = LMDataset(LMConfig(vocab=cfg.vocab, seq_len=32), 4,
                         device="cpu")
        batch = train.next_batch(cfg, data, 0, 4, 32)
        step = st.make_train_step(cfg, opt_cfg, 32)
        pc, oc, mc = step(card, adamw_init(card),
                          {k: v.cuda() for k, v in batch.items()})
        ph, oh, mh = step(host, adamw_init(host), batch)
        loss_err = abs(float(mc["loss"]) - float(mh["loss"])) / abs(
            float(mh["loss"]))
        gh = [m / (1 - opt_cfg.b1) for m in _tree.leaves(oh.m)]
        gc = [m.cpu() / (1 - opt_cfg.b1) for m in _tree.leaves(oc.m)]
        gmax = max(float(g.abs().max()) for g in gh)
        grad_err = max(max_err(a, b) for a, b in zip(gc, gh)) / gmax
        pmax = max(float(p.abs().max()) for p in _tree.leaves(ph))
        lr = float(mh["lr"])
        param_err, n_free, n_all = 0.0, 0, 0
        for (path, a), b, g_c, g_h in zip(_tree.leaves_with_path(pc),
                                          _tree.leaves(ph), gc, gh):
            err = (a.cpu().double() - b.double()).abs()
            free = ((g_h.abs() <= 2 * (g_c - g_h).abs())
                    & ((g_h != 0) | (g_c != 0)))
            over = err > 1e-4 * pmax + torch.where(free, 2 * lr, 0.0)
            check(not bool(over.any()),
                  f"{name} reduced train step: {path} card vs CPU "
                  f"{float(err.max()):.3g} > 1e-4 of max|param| {pmax:.3g}")
            param_err = max(param_err, float(err[~free].max())
                            if bool((~free).any()) else 0.0)
            n_free += int(free.sum())
            n_all += free.numel()
        check(loss_err <= TOL_CARD_VS_CPU and grad_err <= TOL_CARD_VS_CPU
              and n_free <= TOL_SIGN_FREE_SHARE * n_all,
              f"{name} reduced train step: loss {loss_err:.3g}, grads "
              f"{grad_err:.3g}, {n_free} of {n_all} elements sign-free")
        fam = worst.setdefault(cfg.family, {"loss": 0.0, "grads": 0.0,
                                            "params_over_max": 0.0,
                                            "sign_free_elements": 0})
        fam["loss"] = max(fam["loss"], loss_err)
        fam["grads"] = max(fam["grads"], grad_err)
        fam["params_over_max"] = max(fam["params_over_max"],
                                     param_err / pmax)
        fam["sign_free_elements"] += n_free
    return worst


def zoo_train_runs(torch, out_dir: Path):
    """Phase 8: the four full-width archs through the launcher and its
    pieces, the resume check, the ten reduced archs card vs CPU; prints
    one line per arch and writes ``<out>/chip_smoke_zoo_train.json``."""
    report = {"device": nvidia_smi(), "full": {}}
    draws = {}
    for name in ZOO_TRAIN:
        t0 = time.perf_counter()
        entry, draws[name] = zoo_train_arch(torch, name)
        entry["phase_s"] = time.perf_counter() - t0
        report["full"][name] = entry
        print(f"zoo train {name}: {entry['params']} params, B={entry['batch']}"
              f" S={entry['seq']}: step {entry['step_ms']:.1f} ms "
              f"({entry['tokens_per_s']:.0f} tok/s); profiled step "
              f"{entry['profiled_step_wall_ms']:.1f} ms, "
              f"{entry['device_launches_per_step']} launches, device busy "
              f"{entry['device_busy_ms']:.1f} ms (idle "
              f"{1 - entry['device_busy_share']:.3f}); bound "
              f"{entry['bound_ms']:.2f} ms ({entry['bound_by']}: "
              f"{entry['step_flops']:.4g} FLOP); peak "
              f"{entry['peak_bytes'] / 2**30:.2f} GiB against "
              f"p+g+m+v {entry['params_grads_m_v_bytes'] / 2**30:.2f} + "
              f"saved {entry['saved_activation_bytes'] / 2**30:.2f} GiB; "
              f"{entry['batch_source']} {entry['batch_ms']:.1f} ms/batch; "
              f"prune {entry['prune_ms']:.1f} ms; loss "
              f"{entry['first_loss']:.4f} -> {entry['last_loss']:.4f}",
              flush=True)
        for row in entry["by_kernel"]:
            print(f"  {row['device_ms']:.4f} ms  x{row['count']}  "
                  f"{row['name']}", flush=True)
    report["resume"] = zoo_resume_check(torch, ZOO_RESUME_ARCH,
                                        draws[ZOO_RESUME_ARCH])
    print(f"zoo train resume: {json.dumps(report['resume'])}", flush=True)
    report["reduced_card_vs_cpu_by_family"] = zoo_train_reduced_checks(
        torch, 0)
    print(f"zoo train reduced card vs CPU: "
          f"{json.dumps(report['reduced_card_vs_cpu_by_family'])}",
          flush=True)
    (out_dir / "chip_smoke_zoo_train.json").write_text(
        json.dumps(report, indent=1))
    return report


# -- phase 9: sharded serving at full width -----------------------------------


def shard_placement(torch, n: int):
    """(context, what): N distinct cards when that many are visible, else
    N logical shards on cuda:0 (``launch.mesh.emulated_devices``)."""
    from repro_torch.launch.mesh import emulated_devices

    if torch.cuda.device_count() >= n:
        return contextlib.nullcontext(), f"{n} distinct card(s)"
    return emulated_devices(n), f"{n} logical shard(s) on cuda:0"


def head_batch_invariant(torch, engine, batch: int) -> bool:
    """Whether the engine's head gives each row the same bits at
    ``batch`` rows as at CAPACITY.  The head's fp32 GEMMs are the chunk's
    only ops whose sums the library may order by batch (cuBLAS picks its
    kernel by shape): every kernel of the route keeps a slot's sums in an
    order of its own, and the sorts and top-k are exact.  So a route's
    sharded chunk is batch-invariant where its head is."""
    hidden = engine.layers[-1].hidden_dim
    gen = torch.Generator(device=engine.device).manual_seed(1)
    h = torch.randn((CAPACITY, hidden), generator=gen, device=engine.device)
    return torch.equal(engine.head(h)[:batch], engine.head(h[:batch]))


def timed_serve(torch, rt, engine, requests, capacity, n_devices):
    """``serve_requests`` after one untimed wave, with the host time of
    every shard's ``step_chunk`` summed per pool dispatch.  Returns the
    results, the stats, the wall and the host ms per dispatch."""
    warm = [rt.StreamRequest(r.req_id, 0, r.feats[:2 * CHUNK_FRAMES])
            for r in requests[:capacity]]
    rt.serve_requests(engine, warm, capacity, chunk_frames=CHUNK_FRAMES,
                      n_devices=n_devices)
    host = [0.0]
    chunk = rt.BatchedSpartusEngine.step_chunk

    def timed_chunk(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = chunk(self, *args, **kwargs)
        host[0] += time.perf_counter() - t0
        return out

    rt.BatchedSpartusEngine.step_chunk = timed_chunk
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, stats = rt.serve_requests(
            engine, requests, capacity, chunk_frames=CHUNK_FRAMES,
            n_devices=n_devices)
        wall = time.perf_counter() - t0
    finally:
        rt.BatchedSpartusEngine.step_chunk = chunk
    return results, stats, wall, host[0] * 1e3 / stats.n_dispatches


def sharded_runs(torch, params, am_cfg, requests, out_dir: Path):
    """Phase 9: phase 3's model and requests through ``serve_requests``
    with N = 1, 2 and 4 shards on the "auto" and scatter routes and N = 1
    and 4 on scatter+int8, on distinct cards where that many are visible,
    else as logical shards on the one card; capacity 6 over 4 shards (the
    one-shard fallback); least-loaded admission; the async server over 4
    shards with phase 4's drip-fed clients under sync debug mode "error".
    Returns the kernels' launches on the sharded path and the report.
    Those are counted only over the runs of pools of more than one shard
    (the timed and profiled N > 1 runs, the 4-shard async server): the
    batch-1 oracle, the N=1 baselines, the one-shard fallback and the
    unsharded runs the checks compare with are outside the count."""
    from repro_torch import serving as rt
    from repro_torch.core import QuantConfig

    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)

    @contextlib.contextmanager
    def counted(on: bool = True):
        """Adds the launches made inside the block to ``launches``."""
        if not on:
            yield
            return
        zero_counts(counters)
        yield
        for name, n in read_counts(torch, counters).items():
            launches[name] += n

    wave = profile_wave_requests(rt, requests)
    report = {"placement": {}, "runs": [], "profiles": []}
    for route, quant, counts in SHARD_ROUTES:
        label = route + ("+int8" if quant else "")
        ecfg = rt.EngineConfig(theta=am_cfg.theta, gamma=GAMMA, m=M,
                               spmv_path=route,
                               quant=QuantConfig() if quant else None)
        engine = rt.BatchedSpartusEngine(params, am_cfg, ecfg)
        batch1 = rt.SpartusEngine(params, am_cfg, ecfg)
        b1 = [batch1.run_utterance(requests[i].feats).cpu().numpy()
              for i in range(2)]
        base = None
        for n in counts:
            ctx, where = shard_placement(torch, n)
            report["placement"][n] = where
            with ctx, counted(n > 1):
                results, stats, wall, host_ms = timed_serve(
                    torch, rt, engine, requests, CAPACITY, n)
                prof, _ = profile_wave(torch, rt, engine, wave, n)
            n_shards = prof["n_shards"]
            check(n_shards == n, f"sharded {label} N={n}: {n_shards} shards")
            check(len(results) == N_REQUESTS and all(
                r.logits.shape == (q.n_frames, am_cfg.n_classes)
                and np.isfinite(r.logits).all()
                for r, q in zip(results, requests)),
                f"sharded {label} N={n}: results malformed")
            err_b1 = max(float(np.abs(results[i].logits - b1[i]).max())
                         for i in range(2))
            check(err_b1 <= TOL_POOL_VS_BATCH1,
                  f"sharded {label} N={n}: vs batch-1 max err {err_b1}")
            if base is None:
                base = results
            invariant = head_batch_invariant(torch, engine, CAPACITY // n)
            gap = max(float(np.abs(a.logits - b.logits).max())
                      for a, b in zip(results, base))
            equal = all(np.array_equal(a.logits, b.logits)
                        for a, b in zip(results, base))
            check(equal if invariant else gap <= TOL_POOL_VS_BATCH1,
                  f"sharded {label} N={n}: vs the unsharded pool max gap "
                  f"{gap} (head batch-invariant: {invariant})")
            entry = {
                "route": label, "n_devices": n, "placement": where,
                "frames": stats.total_frames, "wall_s": wall,
                "frames_per_s": stats.total_frames / wall,
                "n_dispatches": stats.n_dispatches,
                "host_ms_per_dispatch": host_ms,
                "host_overlap_frac": stats.host_overlap_frac,
                "head_batch_invariant": invariant,
                "equal_to_unsharded": equal, "max_gap_to_unsharded": gap,
                "vs_batch1_max_err": err_b1,
                "launches_per_layer_frame": prof["launches_per_layer_frame"],
                "device_busy_s": prof["device_busy_s"],
                "device_idle_share": prof["device_idle_share"],
                "profiled_wall_s": prof["wall_s"],
            }
            report["runs"].append(entry)
            report["profiles"].append(dict(prof, route=label, n_devices=n))
            print(f"sharded {label} N={n} ({where}): frames/s "
                  f"{entry['frames_per_s']:.1f} host_ms/dispatch "
                  f"{host_ms:.3f} launches/layer-frame "
                  f"{entry['launches_per_layer_frame']:.2f} idle_share "
                  f"{entry['device_idle_share']:.4f} equal_to_unsharded "
                  f"{equal} (head batch-invariant {invariant}, max gap "
                  f"{gap:.3g}) vs_batch1 {err_b1:.3g}", flush=True)

    # the one-shard fallback and least-loaded admission, on "auto"
    engine = rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
        theta=am_cfg.theta, gamma=GAMMA, m=M))
    few = requests[:2 * SHARD_FALLBACK_CAPACITY]
    plain, _ = rt.serve_requests(engine, few, SHARD_FALLBACK_CAPACITY,
                                 chunk_frames=CHUNK_FRAMES)
    ctx, where = shard_placement(torch, 4)
    with ctx:
        pool = rt.SessionPool(engine, SHARD_FALLBACK_CAPACITY,
                              chunk_frames=CHUNK_FRAMES, n_devices=4)
        fallback, _ = rt.serve_requests(engine, few, SHARD_FALLBACK_CAPACITY,
                                        chunk_frames=CHUNK_FRAMES,
                                        n_devices=4)
        placed = rt.SessionPool(engine, CAPACITY, max_frames=MAX_FRAMES,
                                chunk_frames=CHUNK_FRAMES, n_devices=4)
    check(pool.n_shards == 1 and all(
        np.array_equal(a.logits, b.logits) for a, b in zip(fallback, plain)),
        f"sharded fallback: {pool.n_shards} shards, or logits differ")
    loads = []
    for r in requests[:6]:
        placed.admit(r, 0)
        loads.append(placed.shard_loads())
    check(loads[3] == [1, 1, 1, 1] and loads[5] == [2, 2, 1, 1],
          f"sharded admission: shard loads {loads}")
    placed.drain(0)
    report["fallback"] = {"capacity": SHARD_FALLBACK_CAPACITY,
                          "n_devices": 4, "n_shards": pool.n_shards,
                          "equal_to_unsharded": True}
    report["admission_shard_loads"] = loads
    print(f"sharded fallback: capacity {SHARD_FALLBACK_CAPACITY} over 4 "
          f"devices -> {pool.n_shards} shard, logits equal to the "
          f"unsharded pool; admission shard loads {loads}", flush=True)

    # the async server over 4 shards, phase 4's clients
    clients = make_stream_clients(am_cfg, np.random.default_rng(
        SHARD_STREAM_SEED))
    ctx, where = shard_placement(torch, 4)
    with ctx, counted():
        serve_streams(torch, engine, [dict(
            c, feats=c["feats"][:2 * CHUNK_FRAMES], start=0.0,
            blocks=[(0, 2 * CHUNK_FRAMES)], gaps=[0.0], cancel_at=None,
            slow=False) for c in clients[:CAPACITY]], n_devices=4)
        run = serve_streams(torch, engine, clients, timed=True, n_devices=4)
    check(run["srv"].pool.n_shards == 4 and run["srv"].pool.n_active == 0,
          "sharded stream: not 4 shards, or the pool did not end empty")
    done = {}
    for c, out in zip(clients, run["outs"]):
        if c["cancel_at"] is not None:
            check(out["cancelled"], f"sharded stream: client {c['id']} was "
                                    f"not cancelled")
            continue
        res = out["result"]
        check(np.array_equal(np.concatenate([p.rows for p in out["parts"]]),
                             res.logits),
              f"sharded stream: client {c['id']} partials differ from its "
              f"result")
        done[c["id"]] = res
    ids = sorted(done)
    sync, _ = rt.serve_requests(engine, [
        rt.StreamRequest(i, 0, clients[i]["feats"]) for i in ids],
        CAPACITY, chunk_frames=CHUNK_FRAMES)
    err = max(float(np.abs(done[i].logits - r.logits).max())
              for i, r in zip(ids, sync))
    check(len(ids) == N_STREAM_CLIENTS - len(CANCELLED_CLIENTS)
          and err <= TOL_POOL_VS_BATCH1,
          f"sharded stream: {len(ids)} results, vs serve_requests {err}")
    stats = run["srv"].stats()
    timing = run["timing"]
    frames = int(sum(done[i].logits.shape[0] for i in ids))
    report["stream"] = {
        "placement": where, "clients": N_STREAM_CLIENTS,
        "completed": len(ids), "frames": frames, "wall_s": run["wall"],
        "frames_per_s": frames / run["wall"],
        "p50_latency_s": stats.p50_latency_s,
        "p99_latency_s": stats.p99_latency_s,
        "n_dispatches": stats.n_dispatches,
        "sync_check": "no blocking sync under sync debug mode 'error'",
        "tick_wall_ms": summary(timing["wall_ms"]),
        "dispatch_host_ms": summary(timing["dispatch_ms"]),
        "chunk_device_span_ms": summary(timing["chunk_device_span_ms"]),
        "vs_serve_requests_max_err": err}
    print(f"sharded stream N=4 ({where}): {json.dumps(report['stream'])}",
          flush=True)
    for name, n in launches.items():
        # the batch-1 SpMV serves only the batch-1 engine, never a pool
        if name == "stsp_spmv":
            check(n == 0, f"{name}: {n} launches on the sharded path")
        else:
            check(n > 0, f"{name}: no launch on the sharded path")
    report["launches"] = launches
    (out_dir / "chip_smoke_sharded.json").write_text(
        json.dumps(report, indent=1))
    return launches, report


# -- phase 10: sharded training at full width ---------------------------------


def sharded_train_arch(torch, name):
    """Phase 10 for one arch (see the module docstring): the one-device
    launcher run, the sharded one on (1, 4), the restore onto (2, 2) and
    its steps, the dry run's counts beside them."""
    from repro_torch import _tree
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMConfig, LMDataset
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, elastic, train
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import compat_make_mesh, emulated_devices
    from repro_torch.models.config import ShapeCell
    from repro_torch.training.checkpoint import CheckpointManager

    cfg, dev = get_arch(name), torch.device("cuda", 0)
    b, s = ZOO_TRAIN_BATCH, ZOO_TRAIN_SEQ
    n, steps = SHARD_TRAIN_DEVICES, SHARD_TRAIN_STEPS
    argv = zoo_train_argv(name, steps)
    opt_cfg = train.adamw_config(train.parse_args(argv))
    step = st.make_train_step(cfg, opt_cfg, s)
    cell = ShapeCell(f"train_b{b}_s{s}", s, b, "train")
    entry = {"placement": shard_placement(torch, n)[1], "batch": b, "seq": s}

    with emulated_devices(1):          # one device even where there are more
        one, log = run_launcher(train, argv)
    check(log[0].startswith(f"[train] arch={name} mesh={{'data': 1, "
                            f"'model': 1}} devices=1"),
          f"{name}: one-device launcher log {log[:1]}")
    one_losses = [one.losses[i] for i in range(1, steps + 1)]
    one_state = sh.host_tree((one.params, one.opt_state))
    del one
    torch.cuda.empty_cache()

    def card_peaks():
        return [torch.cuda.max_memory_allocated(i) for i in
                range(min(n, torch.cuda.device_count()))]

    def reset_peaks():
        for i in range(min(n, torch.cuda.device_count())):
            torch.cuda.reset_peak_memory_stats(i)

    def dry(mesh_shape):
        rec = dryrun.cell_record(cfg, cell, compat_make_mesh(
            mesh_shape, ("data", "model"), "meta"), dtype=torch.float32)
        return rec, rec["memory"]["params_bytes"] + rec["memory"]["opt_bytes"]

    ckpt = ROOT / "build" / "zoo_shard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        reset_peaks()
        with shard_placement(torch, n)[0]:
            run, log = run_launcher(train, argv + ["--ckpt-dir", str(ckpt)])
        check(log[0].startswith(f"[train] arch={name} mesh={{'data': 1, "
                                f"'model': {n}}} devices={n}"),
              f"{name}: sharded launcher log {log[:1]}")
        losses = [run.losses[i] for i in range(1, steps + 1)]
        check(losses == one_losses, f"{name}: sharded losses {losses} are "
              f"not the one-device run's {one_losses}")
        for (path, a), c in zip(
                _tree.leaves_with_path(sh.host_tree((run.params,
                                                     run.opt_state))),
                _tree.leaves(one_state)):
            check(torch.equal(a, c), f"{name}: {path} after {steps} sharded "
                  f"steps differs from the one-device run's")
        rec14, dry14 = dry((1, n))
        placed = sh.placed_bytes((run.params, run.opt_state))
        check(placed == [dry14] * n, f"{name}: placed bytes {placed} are not "
              f"the dry run's {dry14} per device")
        windows = [w * 1e3 for i, w in enumerate(run.window_s_per_step, 1)
                   if i > 1 and i % ZOO_TRAIN_EVERY]
        batch = train.next_batch(cfg, run.data, steps, b, s)
        prof = profile_step(torch, lambda: step(run.params, run.opt_state,
                                                batch))
        entry["mesh_1x4"] = {
            "losses": losses, "step_ms": float(np.median(windows)),
            "placed_bytes_per_device": placed, "dry_run_bytes": dry14,
            "peak_bytes_per_card": card_peaks(),
            "dry_run_peak_bytes": rec14["memory"]["peak_bytes"],
            "dry_run_peak_bytes_one_card": _one_card(rec14, placed),
            "dry_run_flops_replica_step": rec14["flops_replica_step"],
            "dry_run_collective_bytes": rec14["roofline"]["coll_breakdown"],
            **{k: v for k, v in prof.items() if k != "by_kernel"}}
        del run, batch
        torch.cuda.empty_cache()

        (params, opt), meta, at = CheckpointManager(str(ckpt)).restore_latest(
            one_state)
        check(at == steps and meta["data_step"] == steps,
              f"{name}: checkpoint at {at}, {meta}")
        for (path, a), c in zip(_tree.leaves_with_path((params, opt)),
                                _tree.leaves(one_state)):
            check(torch.equal(a, c), f"{name}: restored {path} differs")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    def more_steps(state):
        data = LMDataset(LMConfig(vocab=cfg.vocab, seq_len=s), b, device=dev)
        data.load_state_dict({"step": steps})
        out, times = [], []
        for k in range(SHARD_TRAIN_MORE):
            batch = train.next_batch(cfg, data, steps + k, b, s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, m = step(*state, batch)
            out.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        return state, out, times, batch

    reset_peaks()
    with shard_placement(torch, n)[0]:
        mesh22 = compat_make_mesh((2, n // 2), ("data", "model"), dev)
    state = [elastic.reshard(t, mesh22, cfg) for t in (params, opt)]
    rec22, dry22 = dry((2, n // 2))
    placed22 = sh.placed_bytes(state)
    check(placed22 == [dry22] * n, f"{name}: placed bytes on (2, 2) "
          f"{placed22} are not the dry run's {dry22} per device")
    state, losses22, ms22, batch = more_steps(state)
    check(all(np.isfinite(losses22)), f"{name}: losses on (2, 2) {losses22}")
    prof = profile_step(torch, lambda: step(*state, batch))
    entry["mesh_2x2"] = {
        "losses": losses22, "step_ms": ms22[-1],
        "placed_bytes_per_device": placed22, "dry_run_bytes": dry22,
        "peak_bytes_per_card": card_peaks(),
        "dry_run_peak_bytes": rec22["memory"]["peak_bytes"],
        "dry_run_peak_bytes_one_card": _one_card(rec22, placed22),
        "dry_run_flops_replica_step": rec22["flops_replica_step"],
        "dry_run_collective_bytes": rec22["roofline"]["coll_breakdown"],
        **{k: v for k, v in prof.items() if k != "by_kernel"}}
    del state, batch
    torch.cuda.empty_cache()

    _, one_more, _, _ = more_steps([_tree.tree_map(lambda t: t.to(dev), x)
                                    for x in (params, opt)])
    entry["one_device_losses_after"] = one_more
    entry["loss_gap_2x2"] = max(abs(a - c) / abs(c)
                                for a, c in zip(losses22, one_more))
    check(entry["loss_gap_2x2"] <= TOL_SHARD_LOSS,
          f"{name}: (2, 2) losses {losses22} against one device's "
          f"{one_more}")
    flops = train_step_flops(cfg, st.abstract_params(cfg, torch.float32),
                             b, s)
    entry.update(train_step_flops=flops, dry_run_over_train_step_flops=(
        entry["mesh_1x4"]["dry_run_flops_replica_step"] / flops))
    del params, opt, one_state
    torch.cuda.empty_cache()
    return entry


def _one_card(rec, placed):
    """The dry run's peak for one card that holds every logical device of
    the mesh: the busiest device's peak and the others' placed state."""
    return rec["memory"]["peak_bytes"] + sum(placed[1:])


def sharded_train_runs(torch, out_dir: Path):
    """Phase 10: ``sharded_train_arch`` for each of ``SHARD_TRAIN``; one
    line per arch and mesh, ``<out>/chip_smoke_sharded_train.json``."""
    report = {"device": nvidia_smi(), "cards": torch.cuda.device_count(),
              "archs": {}}
    for name in SHARD_TRAIN:
        t0 = time.perf_counter()
        entry = sharded_train_arch(torch, name)
        entry["phase_s"] = time.perf_counter() - t0
        report["archs"][name] = entry
        for key in ("mesh_1x4", "mesh_2x2"):
            m = entry[key]
            print(f"sharded train {name} {key[5:]} ({entry['placement']}): "
                  f"step {m['step_ms']:.1f} ms; profiled step "
                  f"{m['profiled_step_wall_ms']:.1f} ms, "
                  f"{m['device_launches_per_step']} launches, idle "
                  f"{1 - m['device_busy_share']:.3f}; placed "
                  f"{m['placed_bytes_per_device'][0]} B per device (dry run "
                  f"{m['dry_run_bytes']}); peak per card "
                  f"{[round(p / 2**30, 2) for p in m['peak_bytes_per_card']]}"
                  f" GiB (dry run {m['dry_run_peak_bytes'] / 2**30:.2f} GiB "
                  f"per device, {m['dry_run_peak_bytes_one_card'] / 2**30:.2f}"
                  f" GiB for one card holding all); dry-run FLOPs per replica "
                  f"step "
                  f"{m['dry_run_flops_replica_step']:.4g}; losses "
                  f"{m['losses']}", flush=True)
        print(f"sharded train {name}: (1, {SHARD_TRAIN_DEVICES}) torch.equal "
              f"to one device over {SHARD_TRAIN_STEPS} steps; (2, 2) losses "
              f"{entry['mesh_2x2']['losses']} vs one device "
              f"{entry['one_device_losses_after']} (gap "
              f"{entry['loss_gap_2x2']:.3g}); dry-run FLOPs "
              f"{entry['mesh_1x4']['dry_run_flops_replica_step']:.4g} vs "
              f"train_step_flops {entry['train_step_flops']:.4g} (x"
              f"{entry['dry_run_over_train_step_flops']:.3f})", flush=True)
    (out_dir / "chip_smoke_sharded_train.json").write_text(
        json.dumps(report, indent=1))
    return report


def boundary_costs(torch, rt, engine, requests, observability=None):
    """Serve ``requests`` (all arriving at once) through one chunked pool
    with ``serve_requests``' loop, ``step_chunk`` instrumented; returns
    the per-call timing summaries and the pool's ``host_overlap_frac``.
    A fetch that waits for the chunk just dispatched shows as a resolve
    time near that chunk's device span."""
    kwargs = {} if observability is None else {"observability": observability}
    pool = rt.SessionPool(engine, CAPACITY,
                          max_frames=max(r.n_frames for r in requests),
                          chunk_frames=CHUNK_FRAMES, **kwargs)
    read = instrument(torch, pool, engine, call="step_chunk")
    pending = list(requests)
    results, now = [], 0
    t_run = time.perf_counter()
    while pending or pool.n_active or pool.has_pending:
        while pending and pool.n_free:
            pool.admit(pending.pop(0), now)
        adv = pool.max_chunk_advance()
        results += pool.step_chunk(now) if adv else pool.flush()
        now += max(adv, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    t = read()
    frames = sum(r.logits.shape[0] for r in results)
    return {"step_chunk_wall_ms": summary(t["wall_ms"]),
            "dispatch_host_ms": summary(t["dispatch_ms"]),
            "resolve_ms": summary(t["resolve_ms"]),
            "fold_ms": summary(t["fold_ms"]),
            "chunk_device_span_ms": summary(t["chunk_device_span_ms"]),
            "host_overlap_frac": pool.mean_host_overlap_frac(),
            "frames": frames, "wall_s": wall, "frames_per_s": frames / wall}


def boundary_only(torch, args) -> int:
    """``--boundary-only``: one tree's chunked-pool boundary costs, for
    comparing two trees in one call (parent, change, change, parent).
    The tree is the one whose ``src`` was put on the path (``--src``):
    the paper's 2x1024 DeltaLSTM on the scatter route, phase 3's 32
    requests at capacity 16 and chunk_frames=16, after one untimed wave;
    with observability too where the tree has it.  Prints one JSON
    line."""
    from repro_torch import serving as rt
    from repro_torch.configs.spartus_lstm import DELTA_LSTM_2L_1024H
    from repro_torch.models import lstm_am

    am_cfg = DELTA_LSTM_2L_1024H
    params = servable_params(lstm_am, am_cfg, args.seed)
    engine = rt.BatchedSpartusEngine(params, am_cfg, rt.EngineConfig(
        theta=am_cfg.theta, gamma=GAMMA, m=M, spmv_path="scatter"))
    requests = make_requests(rt, am_cfg, np.random.default_rng(args.seed))
    boundary_costs(torch, rt, engine, requests[:CAPACITY])
    result = {"label": args.label, "src": args.src, "device": nvidia_smi(),
              "plain": boundary_costs(torch, rt, engine, requests)}
    if hasattr(rt, "PoolObservability"):
        result["observability"] = boundary_costs(
            torch, rt, engine, requests, rt.PoolObservability())
    print(json.dumps(result), flush=True)
    return 0


def sharded_only(torch, args) -> int:
    """``--sharded-only``: the build and phases 9 and 10, nothing else."""
    from repro_torch import serving as rt
    from repro_torch.configs.spartus_lstm import DELTA_LSTM_2L_1024H
    from repro_torch.kernels import _build
    from repro_torch.models import lstm_am

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"device: {nvidia_smi()} | {torch.cuda.device_count()} card(s)",
          flush=True)
    _build.build()
    am_cfg = DELTA_LSTM_2L_1024H
    params = servable_params(lstm_am, am_cfg, args.seed)
    requests = make_requests(rt, am_cfg, np.random.default_rng(args.seed))
    launches, _ = sharded_runs(torch, params, am_cfg, requests, out_dir)
    print(json.dumps({"sharded_launches": launches}), flush=True)
    sharded_train_runs(torch, out_dir)
    return 0


def launcher_run(runs):
    """The launcher as its users start it, as subprocesses with a time
    limit, one per ``(args, expected output)`` of ``runs``
    (``SPARTUS_LAUNCHES``: the ``--async`` TCP front-end at hidden 1024,
    then the synchronous mode, which trains at its default hidden width
    before it serves a pool; ``ARCH_LAUNCHES``: the ``--arch`` mode);
    returns their ``[serve]`` lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    lines = []
    for args, expect in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=LAUNCHER_TIMEOUT_S,
                                  cwd=ROOT)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"launcher {' '.join(args)} did not exit "
                               f"within {LAUNCHER_TIMEOUT_S} s")
        check(proc.returncode == 0 and all(e in proc.stdout for e in expect),
              f"launcher {' '.join(args)}: exit {proc.returncode}: "
              f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("[serve]"):
                print(f"launcher: {line}", flush=True)
                lines.append(line)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for the build log, serving report and "
                         "profile")
    ap.add_argument("--boundary-only", action="store_true",
                    help="print only the chunked pool's boundary costs "
                         "(see boundary_only) and exit")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="with --boundary-only: the src directory of the "
                         "tree to measure (another commit unpacked with "
                         "git archive builds its kernels under its own "
                         "build/)")
    ap.add_argument("--label", default="this tree",
                    help="with --boundary-only: a name for the tree")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build the kernels and run phases 9 and 10 alone (see "
                         "sharded_only) and exit")
    args = ap.parse_args()

    import torch

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.boundary_only:
        return boundary_only(torch, args)
    if args.sharded_only:
        return sharded_only(torch, args)
    from repro_torch import serving
    from repro_torch.configs.spartus_lstm import DELTA_LSTM_2L_1024H
    from repro_torch.kernels import _build
    from repro_torch.models import lstm_am

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    # phase 1: device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    # phase 2: build + kernels
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    (out_dir / "nvcc_build.log").write_text(lib.with_suffix(".log")
                                            .read_text())
    am_cfg = DELTA_LSTM_2L_1024H
    params = servable_params(lstm_am, am_cfg, args.seed)
    layers = serving.BatchedSpartusEngine(
        params, am_cfg,
        serving.EngineConfig(theta=am_cfg.theta, spmv_path="scatter"),
    ).layers
    rows = kernel_checks(torch, layers, args.seed)
    rows.update(mirror_checks(torch, params, am_cfg, args.seed))
    rows.update(clip_checks(torch, layers, args.seed))
    for name, row in rows.items():
        for case in [row] + row.get("cases", []):
            for key in ("kernel_device_ms", "library_device_ms"):
                # no call beats its bound: a reading under it means the
                # profiler missed events, and it is not kept
                if (case.get(key) is not None
                        and case[key] < case["bound_ms"]):
                    print(f"kernel {name} [{case['case']}]: {key} "
                          f"{case[key]} is under the bound "
                          f"{case['bound_ms']:.6f}: discarded (the "
                          f"profiler missed events)", flush=True)
                    case[key] = None
        for case in row.get("cases", [row]):
            print(f"kernel {name} [{case['case']}]: max_abs_err "
                  f"{case['max_abs_err']:.3g} ms {case['ms']:.5f} "
                  f"kernel_device_ms {case['kernel_device_ms']} plain_ms "
                  f"{case['plain_ms']:.5f} bytes {case['bytes']} "
                  f"bound_ms {case['bound_ms']:.6f} ({case['bound_by']}) "
                  f"library_ms {case.get('library_ms')} library_device_ms "
                  f"{case.get('library_device_ms')} glue_ms "
                  f"{case.get('glue_ms')} glue_device_ms "
                  f"{case.get('glue_device_ms')}", flush=True)

    # phase 3: serving at full width
    launches, requests, served = serving_runs(torch, params, am_cfg,
                                      np.random.default_rng(args.seed),
                                      out_dir)
    mirror_cost(torch, params, am_cfg, requests, args.seed, out_dir)
    profile_serving(torch, params, am_cfg, requests, out_dir)

    # phase 4: the streaming front-end at full width
    stream_launches, _ = streaming_runs(
        torch, params, am_cfg, np.random.default_rng(args.seed + 1), out_dir)
    launcher_run(SPARTUS_LAUNCHES)

    # phase 5: training at full width, the trained weights served
    random_ts = {e["route"]: e["sparsity"]["temporal_sparsity"]
                 for e in served}
    trained_launches = training_runs(torch, requests, random_ts, args.seed,
                                     out_dir)

    # phase 6: hot-path contracts, DeltaGRU / DeltaLinear, an example
    contract_launches = contract_checks(torch, out_dir)
    delta_rnn_checks(torch, args.seed)
    transformer_example(torch)

    # phase 7: the model zoo, at full width and reduced, and its launcher
    counters = kernel_counters()
    zero_counts(counters)
    zoo_runs(torch, args.seed, out_dir)
    zoo_launches = read_counts(torch, counters)

    # phase 8: the model zoo's trainer, at full width and reduced
    zero_counts(counters)
    zoo_train_runs(torch, out_dir)
    zoo_train_launches = read_counts(torch, counters)
    for name, n in zoo_train_launches.items():
        check(n == 0, f"{name}: {n} launches on the zoo's training path, "
                      f"which reaches no kernel")

    # phase 9: sharded serving at full width
    sharded_launches, _ = sharded_runs(torch, params, am_cfg, requests,
                                       out_dir)

    # phase 10: sharded training at full width
    zero_counts(counters)
    sharded_train_runs(torch, out_dir)
    sharded_train_launches = read_counts(torch, counters)
    for name, n in sharded_train_launches.items():
        check(n == 0, f"{name}: {n} launches on the sharded training path, "
                      f"which reaches no kernel")

    kernels = []
    for name, row in rows.items():
        # stsp_spmv (B=1) serves only the batch-1 engine; the others are
        # counted on the pool, the main path
        path = "batch1" if name == "stsp_spmv" else "pool"
        kernels.append({
            "name": name, "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], "launches": launches[path][name],
            "launches_by_path": dict(
                {p: launches[p][name] for p in launches},
                stream=stream_launches[name],
                trained=trained_launches[name],
                contracts=contract_launches[name],
                zoo=zoo_launches[name],
                zoo_train=zoo_train_launches[name],
                sharded=sharded_launches[name],
                sharded_train=sharded_train_launches[name]),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            "kernel_device_ms": row["kernel_device_ms"], "bytes": row["bytes"],
            "note": row.get("note"),
            "cases": row.get("cases", []),
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
