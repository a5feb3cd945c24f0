"""Streaming serving demo: the synchronous chunked pool, then the asyncio
front-end with concurrent incrementally-fed clients — port of
``examples/streaming_server.py``.

Builds a small CBTD-pruned DeltaLSTM acoustic model and serves a burst of
staggered streaming requests two ways:

1. `serve_requests` — the synchronous drain loop (the parity oracle):
   chunked device ticks, logits at retirement.
2. `AsyncSpartusServer` — ten concurrent clients connect, feed their
   utterances a few frames at a time, and receive **partial logits per
   chunk** while the utterance is still in flight.  The streamed rows are
   checked to match the synchronous results at 1e-5.

    python -m repro_torch.examples.streaming_server [--device cpu]
    python -m repro_torch.examples.streaming_server --clients 12 \\
        --target-chunk-ms 20     # wall-clock-paced chunk boundaries
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.speech import SpeechConfig, SpeechDataset
from repro_torch.hwsim import spartus_model as hw
from repro_torch.models import lstm_am
from repro_torch.serving import (
    AsyncSpartusServer, BatchedSpartusEngine, EngineConfig, StreamRequest,
    serve_requests,
)

GAMMA, M, THETA = 0.9375, 4, 0.1


def build(n_requests: int, device, hidden: int = 64, frames: int = 48):
    data_cfg = SpeechConfig(max_frames=frames)
    cfg = lstm_am.LSTMAMConfig(input_dim=data_cfg.feat_dim,
                               hidden_dim=hidden, n_layers=2,
                               n_classes=data_cfg.vocab)
    params = lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=device)
    params = lstm_am.cbtd_prune_stacks(params, gamma=GAMMA, m=M)
    engine = BatchedSpartusEngine(
        params, cfg, EngineConfig(theta=THETA, gamma=GAMMA, m=M),
        device=device)

    # real (synthetic-speech) utterances with ragged lengths:
    feats, frame_lens, _, _ = next(SpeechDataset(data_cfg, n_requests))
    utts = []
    for i in range(n_requests):
        t = int(frame_lens[i]) if int(frame_lens[i]) > 0 else 16
        utts.append(feats[i, :t].numpy().astype(np.float32))
    return engine, utts


def sync_demo(engine, utts, capacity: int, chunk: int):
    """Chunked drain loop: ONE device dispatch advances all slots up to
    `chunk` frames, logits are fetched per session at retirement."""
    rng = np.random.default_rng(0)
    requests = [
        StreamRequest(req_id=i, arrival_step=int(rng.integers(0, 4)) + 4 * i,
                      feats=u)
        for i, u in enumerate(utts)
    ]
    results, stats = serve_requests(engine, requests, capacity=capacity,
                                    chunk_frames=chunk)

    print(f"[sync]  served {stats.n_requests} sessions / "
          f"{stats.total_frames} frames in {stats.wall_s:.2f}s -> "
          f"{stats.frames_per_s:.0f} frames/s (pool capacity "
          f"{stats.capacity}, {stats.chunk_frames}-frame chunks)")
    print(f"[sync]  dispatch economy: {stats.n_dispatches} dispatches "
          f"({stats.dispatches_per_frame:.3f}/frame), host overlap "
          f"{stats.host_overlap_frac:.0%}")
    print(f"[sync]  latency p50 {stats.p50_latency_s*1e3:.0f} ms, "
          f"p95 {stats.p95_latency_s*1e3:.0f} ms; time-to-first-logit "
          f"p50 {stats.p50_ttfl_s*1e3:.0f} ms (== latency: logits "
          f"surface at retirement)")
    return results, stats


async def one_client(server, i, feats, rng):
    """Connect, drip-feed the utterance (as an audio front-end would),
    and collect partial logits per chunk as they stream back."""
    handle = await server.stream(want_partials=True)
    j = 0
    while j < len(feats):
        n = int(rng.integers(2, 6))
        await handle.send(feats[j:j + n])
        j += n
        await asyncio.sleep(float(rng.random()) * 0.002)
    handle.close()
    partials = [p async for p in handle]       # per-chunk [n, n_classes] rows
    result = await handle.result()
    return i, partials, result


async def async_demo(engine, utts, capacity: int, chunk: int,
                     target_chunk_ms: float):
    async with AsyncSpartusServer(
            engine, capacity, chunk_frames=chunk, max_frames=64,
            target_chunk_ms=target_chunk_ms,
            max_pending=2 * capacity) as server:
        rngs = [np.random.default_rng(100 + i) for i in range(len(utts))]
        out = await asyncio.gather(*[
            one_client(server, i, utts[i], rngs[i])
            for i in range(len(utts))])
        stats = server.stats()
    return out, stats


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=10,
                    help="concurrent streaming clients (>= 8 for the demo)")
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--chunk-frames", type=int, default=8)
    ap.add_argument("--target-chunk-ms", type=float, default=0.0,
                    help="wall-clock pacing per chunk (0 = free-run)")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--frames", type=int, default=48,
                    help="longest synthetic utterance")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine, utts = build(args.clients, args.device, args.hidden, args.frames)
    sync_results, sync_stats = sync_demo(engine, utts, args.capacity,
                                         args.chunk_frames)

    out, stats = asyncio.run(async_demo(
        engine, utts, args.capacity, args.chunk_frames,
        args.target_chunk_ms))

    # every client's streamed per-chunk rows concatenate to exactly the
    # synchronous drain loop's logits:
    n_blocks = 0
    for i, partials, result in out:
        streamed = np.concatenate([p.rows for p in partials])
        np.testing.assert_allclose(streamed, sync_results[i].logits,
                                   atol=1e-5)
        np.testing.assert_allclose(result.logits, sync_results[i].logits,
                                   atol=1e-5)
        n_blocks += len(partials)
    print(f"[async] {len(out)} concurrent streaming clients served; "
          f"{n_blocks} partial-logit blocks streamed; parity with "
          f"serve_requests at 1e-5: OK")
    print(f"[async] latency p50 {stats.p50_latency_s*1e3:.0f} ms, "
          f"p95 {stats.p95_latency_s*1e3:.0f} ms, "
          f"p99 {stats.p99_latency_s*1e3:.0f} ms")
    print(f"[async] time-to-first-logit p50 {stats.p50_ttfl_s*1e3:.0f} ms, "
          f"queue wait p95 {stats.p95_queue_wait_s*1e3:.0f} ms "
          f"({stats.n_dispatches} dispatches, "
          f"{stats.dispatches_per_frame:.3f}/frame)")

    # telemetry: accumulated on device across the whole run, fetched once
    # -> drives the hardware model
    sp = stats.sparsity
    print(f"measured temporal sparsity {sp['temporal_sparsity']:.1%}, "
          f"overflow rate {sp['capacity_overflow_rate']:.1%}")
    rep = hw.evaluate_from_telemetry(hw.SPARTUS, hw.TEST_LAYER, GAMMA, sp)
    print(f"modelled Spartus latency at this sparsity: {rep.latency_us:.2f} us"
          f" ({rep.batch1_throughput_gops:.0f} GOp/s effective)")
    return {"clients": len(out), "partial_blocks": n_blocks,
            "sync_frames": sync_stats.total_frames,
            "temporal_sparsity": sp["temporal_sparsity"]}


if __name__ == "__main__":
    main()
