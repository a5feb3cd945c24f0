"""Serving launcher of the port — ``repro/launch/serve.py``: batched
decode for any ``--arch`` of the model zoo (the default mode), or the
paper's Spartus engine in its two ``--spartus`` modes; on the card by
default.

The ``--arch`` mode serves the reduced config of the architecture (as in
the reference, ``--reduced`` is always on) from seeded random weights:
``--steps`` greedy decode steps at ``--batch`` with a ``--ctx``-slot
cache, and prints ms/token.  The ``--spartus`` synchronous mode trains a
small CBTD + DeltaLSTM acoustic model with the two-phase recipe
(``pretrain_retrain``), then serves it: through a session pool
(``serve_requests``, ``--pool N``) or the batch-1 ``SpartusEngine``
(``--pool 0``), and reports the modelled Spartus latency at the
measured sparsity (``hwsim.spartus_model``).  The
``--async`` mode is the asyncio streaming front-end over a localhost TCP
socket.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --batch 2 --steps 4                  # qwen2-0.5b on the host
    PYTHONPATH=src python -m repro_torch.launch.serve --spartus \
        --pool 4 --requests 8 --chunk-frames 16
    PYTHONPATH=src python -m repro_torch.launch.serve --spartus \
        --hidden 16 --requests 4 --device cpu   # batch-1, plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --spartus --async \
        --pool 16 --chunk-frames 16 --clients 8 --hidden 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --spartus --async \
        --pool 4 --clients 8 --hidden 32 --device cpu   # plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --spartus --async \
        --pool 8 --clients 0 --port 8765   # serve forever on :8765

``--devices N`` (with ``--pool`` or ``--async``) shards the pool's slot
dimension over N devices (`serving/sharding.py`) and prints the shard
count; N above the visible cards exits with the overcommit error.  For
now sharding shows placement only and lowers throughput, on one card
or on N: one host thread issues every shard's launches in turn, and the
pool is host-bound, so the host's cost per chunk grows N times
(ROADMAP.md queue 2 item 10 plans the overlapped dispatch):

    PYTHONPATH=src python -m repro_torch.launch.serve --spartus --async \
        --pool 16 --chunk-frames 16 --clients 8 --hidden 1024 --devices 2

The --async mode exposes the `AsyncSpartusServer` over a localhost
TCP socket speaking newline-delimited JSON (one object per line):

    client -> {"op": "open",   "id": 0}        # optional "token": "..."
    server -> {"event": "open_ok", "id": 0}
    client -> {"op": "frames", "id": 0, "frames": [[...], ...]}   # [n, D]
    client -> {"op": "close",  "id": 0}        # end of utterance
    client -> {"op": "cancel", "id": 0}        # abandon mid-utterance
    server -> {"event": "partial", "id": 0, "t0": 0, "logits": [[...], ...]}
    server -> {"event": "done", "id": 0, "n_frames": 40,
               "latency_ms": ..., "ttfl_ms": ..., "queue_wait_ms": ...}
    server -> {"event": "cancelled", "id": 0}
    server -> {"event": "error", "id": 0, "code": "...",
               "retriable": false, "message": "..."}

`id` is chosen by the client and scopes to its connection; multiple
streams may be multiplexed over one connection.  Partial logits arrive
per chunk as they are produced (`target_chunk_ms` paces the boundaries);
`done` closes the stream with its latency breakdown.

Every error carries a stable ``code`` and a ``retriable`` flag
(serving/faults.py) — malformed traffic
(``bad_json`` / ``unknown_op`` / ``no_such_stream`` / ``duplicate_id`` /
``bad_request``) answers in-band and only ever fails the offending
stream; the connection and every other stream stay up.  The one
transport-level violation is a line over ``MAX_LINE_BYTES`` (framing is
lost at that point): the server answers ``line_too_long`` and closes
THAT connection.  Retriable errors (``shed`` under --overload shed,
``timeout`` under --idle-timeout, ``retriable_internal`` after a
watchdog recovery) are retried by the demo client with seeded
full-jitter backoff; ``"token"`` on open makes the retry idempotent
(re-opening a live token returns the same stream instead of
double-admitting).

**Admin surface** (--async): `--admin-port P` opens a second localhost
listener speaking the same JSON-lines convention, read-only, for
operators scraping the live pool:

    client -> {"cmd": "healthz"}
    server -> {"ok": true, "uptime_s": ..., "connected": ..., "capacity": ...}
    client -> {"cmd": "stats"}
    server -> {"stats": { ... ServeStats.to_dict() ... }}
    client -> {"cmd": "metrics"}
    server -> {"metrics": {name: {...}}, "prometheus": "<text exposition>"}
    client -> {"cmd": "timeseries", "last": 64}
    server -> {"timeseries": [{...per-chunk sample...}], "n_dropped": 0}

Unknown commands answer ``{"error": "..."}`` in-band; the connection
stays up.  `--stats-interval S` additionally logs a one-line pool-health
summary every S seconds, and `--trace PATH` records the driver's phase
spans (admission-wave upload, dispatch, snapshot D2H fetch, delivery
pump, pacing idle) to a Chrome trace-event JSON on shutdown — load it in
Perfetto or chrome://tracing.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np

from repro_torch.serving.faults import Backoff, ProtocolError, error_payload

#: JSON-lines framing bound: one message may not exceed this many bytes.
#: Past it the stream's framing is unrecoverable (we cannot know where the
#: runaway line ends a message), so the server answers ``line_too_long``
#: and closes that one connection.
MAX_LINE_BYTES = 1 << 20


def stats_line(server) -> str:
    """One-line live pool-health summary (the --stats-interval log line;
    also what an operator's dashboard would tail).  Prefers the live
    observability counters when attached — `ServeStats.total_frames` only
    counts COMPLETED requests, so mid-utterance progress would read 0."""
    import time as _time

    pool = server.pool
    stats = server.stats()
    obs = server.obs
    frames = (int(obs.c_frames.value) if obs is not None
              else stats.total_frames)
    up = (_time.perf_counter() - server._t_start
          if server._t_start is not None else 0.0)
    rate = frames / up if up > 0 else 0.0
    return (f"[stats] occ {pool.n_active}/{server.capacity} "
            f"conn {server.n_connected} "
            f"frames {frames} ({rate:.0f}/s) "
            f"dispatches {stats.n_dispatches} "
            f"overlap {stats.host_overlap_frac:.0%} "
            f"lagging {len(server._lagging)}")


async def start_admin_server(server, observability, host: str = "127.0.0.1",
                             port: int = 0):
    """Open the read-only admin listener over an `AsyncSpartusServer`:
    newline-delimited JSON commands ``healthz`` / ``stats`` / ``metrics``
    / ``timeseries`` (see the module docstring for the reply schemas).

    Importable on its own (tools/obs_smoke.py, tests) — returns the
    ``asyncio.Server``; close it like any other.  Localhost by default:
    this surface is for operators on the box, not the public protocol."""
    import asyncio
    import json
    import time as _time

    t_started = _time.time()

    def reply(msg):
        if not isinstance(msg, dict):
            raise ValueError("admin commands are JSON objects")
        cmd = msg.get("cmd")
        if cmd == "healthz":
            return {"ok": True, "uptime_s": _time.time() - t_started,
                    "connected": server.n_connected,
                    "capacity": server.capacity}
        if cmd == "stats":
            return {"stats": server.stats().to_dict()}
        if cmd == "metrics":
            return {"metrics": observability.registry.snapshot(),
                    "prometheus": observability.registry.render_prometheus()}
        if cmd == "timeseries":
            last = msg.get("last")
            ts = observability.timeseries
            return {"timeseries": ts.snapshot(
                        last=int(last) if last is not None else None),
                    "n_appended": ts.n_appended, "n_dropped": ts.n_dropped}
        raise ValueError(f"unknown admin command {cmd!r}")

    async def handle(reader, writer):
        try:
            while line := await reader.readline():
                try:
                    out = reply(json.loads(line))
                except Exception as e:   # bad command answers in-band
                    out = {"error": str(e)}
                writer.write((json.dumps(out) + "\n").encode())
                await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()

    return await asyncio.start_server(handle, host, port)


def jline(writer, obj):
    """Write one JSON-lines message (module-level: the protocol tests and
    the demo client share it with the connection handler)."""
    writer.write((json.dumps(obj) + "\n").encode())


async def handle_conn(server, reader, writer):
    """One JSON-lines client connection over an `AsyncSpartusServer`.

    Module-level so the protocol tests can drive it against in-memory
    stream pairs.  Malformed traffic — bad
    JSON, unknown ops, frames before open, duplicate opens, invalid
    payloads — answers with a typed in-band ``error`` event (codes from
    serving/faults.py) and fails at most the offending stream; every
    other stream on the connection, and every other connection, is
    untouched.  The single transport-level failure is an over-long line
    (``MAX_LINE_BYTES``): framing is unrecoverable, so the handler
    answers ``line_too_long`` and closes this one connection."""
    handles = {}
    pumps = []

    async def pump_out(cid, handle):
        try:
            async for p in handle:
                jline(writer, {"event": "partial", "id": cid,
                               "t0": p.t0, "logits": p.rows.tolist()})
                await writer.drain()
            r = await handle.result()
            jline(writer, {
                "event": "done", "id": cid,
                "n_frames": int(r.logits.shape[0]),
                "latency_ms": r.wall_latency_s * 1e3,
                "ttfl_ms": r.ttfl_s * 1e3,
                "queue_wait_ms": r.queue_wait_s * 1e3})
            await writer.drain()
        except asyncio.CancelledError:
            try:
                jline(writer, {"event": "cancelled", "id": cid})
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass             # connection already gone
            raise
        except Exception as e:   # reaped / lost-in-recovery: typed + in-band
            try:
                jline(writer, {"event": "error", "id": cid,
                               **error_payload(e)})
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass

    try:
        while True:
            try:
                line = await reader.readline()
            except ValueError:   # reader limit: the line never terminated
                jline(writer, {"event": "error", "id": None,
                               **error_payload(ProtocolError(
                                   "line_too_long",
                                   f"message exceeds {MAX_LINE_BYTES} "
                                   f"bytes; closing connection"))})
                await writer.drain()
                break
            if not line:
                break
            msg = None           # stays None if this line fails to parse
            try:
                try:
                    msg = json.loads(line)
                except Exception:
                    raise ProtocolError("bad_json",
                                        "line is not valid JSON") from None
                if not isinstance(msg, dict) or "op" not in msg:
                    raise ProtocolError(
                        "bad_json", "message must be an object with an 'op'")
                op, cid = msg["op"], msg.get("id", 0)
                if op == "open":
                    if cid in handles:
                        raise ProtocolError(
                            "duplicate_id",
                            f"stream {cid} is already open on this "
                            f"connection")
                    handles[cid] = await server.stream(
                        want_partials=True, token=msg.get("token"))
                    pumps.append(asyncio.create_task(
                        pump_out(cid, handles[cid])))
                    jline(writer, {"event": "open_ok", "id": cid})
                    await writer.drain()
                elif op in ("frames", "close", "cancel"):
                    if cid not in handles:
                        raise ProtocolError(
                            "no_such_stream",
                            f"stream {cid} is not open on this connection "
                            f"(send 'open' first)")
                    if op == "frames":
                        if "frames" not in msg:
                            raise ProtocolError(
                                "bad_json",
                                "'frames' op requires a 'frames' field")
                        await handles[cid].send(
                            np.asarray(msg["frames"], np.float32))
                    elif op == "close":
                        handles[cid].close()
                    else:
                        handles[cid].cancel()
                else:
                    raise ProtocolError("unknown_op", f"unknown op {op!r}")
            except asyncio.CancelledError:
                raise
            except Exception as e:  # typed, in-band; connection stays up
                jline(writer, {"event": "error",
                               "id": msg.get("id") if isinstance(msg, dict)
                               else None, **error_payload(e)})
                await writer.drain()
    finally:
        for cid, h in handles.items():
            h.cancel()           # connection gone: abandon open streams
        for t in pumps:
            t.cancel()
        # retrieve the pumps' outcomes BEFORE closing the transport so
        # a cancelled pump's last write never lands on a closed writer
        # (and no "exception was never retrieved" warnings are logged):
        await asyncio.gather(*pumps, return_exceptions=True)
        writer.close()


async def demo_client(port, cid, feats, *, max_attempts=6, seed=None):
    """Stream one utterance over TCP, retrying retriable errors.

    The client half of the robustness story: it opens with an idempotent
    token (a retry after a dropped ``open_ok`` cannot double-admit), and
    on a retriable error (``shed``, ``timeout``, ``retriable_internal``)
    it backs off with seeded full-jitter delays — honouring the server's
    ``retry_after_ms`` hint when present — and resends the utterance."""
    backoff = Backoff(seed=cid if seed is None else seed)
    token = f"demo-{cid}"
    last = None
    for attempt in range(max_attempts):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        jline(writer, {"op": "open", "id": cid, "token": token})
        await writer.drain()
        msg = json.loads(await reader.readline())
        if msg.get("event") == "error":
            writer.close()
            last = msg
            if not msg.get("retriable"):
                raise RuntimeError(f"server error: {msg}")
            await asyncio.sleep(max(msg.get("retry_after_ms", 0.0) / 1e3,
                                    backoff.delay(attempt)))
            continue
        assert msg.get("event") == "open_ok", msg
        for j in range(0, len(feats), 8):       # stream in 8-frame slices
            jline(writer, {"op": "frames", "id": cid,
                           "frames": feats[j:j + 8].tolist()})
            await writer.drain()
            await asyncio.sleep(0.005)
        jline(writer, {"op": "close", "id": cid})
        await writer.drain()
        rows, done, retry = [], None, False
        while line := await reader.readline():
            msg = json.loads(line)
            if msg["event"] == "partial":
                rows.append(np.asarray(msg["logits"], np.float32))
            elif msg["event"] == "done":
                done = msg
                break
            elif msg["event"] == "error" and msg.get("retriable"):
                last, retry = msg, True
                break
            else:
                raise RuntimeError(f"server error: {msg}")
        writer.close()
        if retry:
            await asyncio.sleep(backoff.delay(attempt))
            continue
        return cid, np.concatenate(rows), done
    raise RuntimeError(
        f"client {cid}: gave up after {max_attempts} attempts ({last})")


def serve_arch(args):
    """Greedy batched decode of ``--arch`` through ``api.serve_step``, as
    the reference's ``serve_arch``: one warm-up step, then ``--steps``
    timed steps, each feeding back its argmax (the vlm family feeds the
    same random embedding every step)."""
    import time

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.models import api

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    cache = api.init_cache(cfg, args.batch, args.ctx, device=device)
    if cfg.family == "vlm":
        inputs = torch.randn((args.batch, 1, cfg.d_model), device=device,
                             generator=torch.Generator(device).manual_seed(1))
    else:
        inputs = torch.zeros((args.batch, 1), dtype=torch.int32,
                             device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        logits, cache = api.serve_step(params, cfg, inputs, cache)  # warm-up
        sync()
        t0 = time.perf_counter()
        toks = inputs
        for _ in range(args.steps):
            logits, cache = api.serve_step(params, cfg, toks, cache)
            if cfg.family != "vlm":
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
        sync()
    dt = (time.perf_counter() - t0) / args.steps
    print(f"[serve] {cfg.name}: {args.steps} steps batch={args.batch} "
          f"-> {dt*1e3:.2f} ms/token ({args.batch/dt:.1f} tok/s)")


def pool_devices(args, device, capacity: int):
    """``--devices`` as the pool's ``n_devices`` (None for 0), checked
    against the visible devices before anything is built: more than are
    visible exits with the overcommit error."""
    if args.devices <= 0:
        return None
    from repro_torch.serving import sharding as shardlib

    try:
        mesh = shardlib.make_pool_mesh(args.devices, device)
    except ValueError as exc:
        sys.exit(f"serve: --devices {args.devices}: {exc}")
    print(f"[serve] sharding the pool's {capacity} slots over "
          f"{args.devices} device(s): "
          f"{shardlib.n_pool_shards(mesh, capacity)} shard(s) "
          f"(slot-dimension data parallelism)")
    return args.devices


def serve_spartus(args):
    """The synchronous mode: train (``pretrain_retrain``: 2 epochs of CBTD
    pretrain at delta_alpha 0.5, then 1 DeltaLSTM retrain epoch, 15 steps
    each, as the reference's launcher), then serve the retrained weights
    and model the Spartus latency at the sparsity they reach.  As in the
    reference the deterministic CBTD never reaches alpha = 1 in this
    recipe, so the model arrives at the pack unpruned and the pack clips
    it to BLEN: the "pack overflow" count says how many weights that
    dropped."""
    import time

    from repro_torch._device import resolve_device
    from repro_torch.core import QuantConfig
    from repro_torch.data.speech import SpeechConfig, SpeechDataset
    from repro_torch.hwsim import spartus_model as hw
    from repro_torch.models import lstm_am
    from repro_torch.serving import (
        BatchedSpartusEngine, EngineConfig, SpartusEngine, StreamRequest,
        serve_requests,
    )
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, pretrain_retrain

    device = resolve_device(args.device)
    n_devices = pool_devices(args, device, args.pool) if args.pool else None
    cfg = TrainConfig(
        model=lstm_am.LSTMAMConfig(input_dim=123, hidden_dim=args.hidden,
                                   n_layers=2, n_classes=41),
        data=SpeechConfig(max_frames=64),
        opt=AdamWConfig(lr=3e-3), batch_size=8, steps_per_epoch=15,
        cbtd_gamma=args.gamma, cbtd_m=8, cbtd_delta_alpha=0.5,
    )
    print(f"[serve] training a small CBTD+DeltaLSTM AM first on {device} "
          f"...")
    pre, post, rcfg = pretrain_retrain(cfg, 2, 1, theta=args.theta,
                                       device=device)
    print(f"[serve] trained {pre.steps}+{post.steps} steps: loss "
          f"{pre.losses[0]:.2f} -> {post.final_loss:.2f}")
    quant = QuantConfig() if args.quant else None
    if quant is not None:
        print("[serve] quantized serving: int8 weights, Q8.8 activations")
    ecfg = EngineConfig(theta=args.theta, gamma=args.gamma, m=8, quant=quant)

    if args.pool > 0:
        engine = BatchedSpartusEngine(post.params, rcfg.model, ecfg,
                                      device=device)
        n_req = max(args.requests, 1)
        feats, n_frames, *_ = next(SpeechDataset(cfg.data, n_req))
        reqs = [
            StreamRequest(req_id=i, arrival_step=2 * i,
                          feats=feats[i, :max(int(n_frames[i]), 8)].numpy())
            for i in range(n_req)
        ]
        results, stats = serve_requests(engine, reqs, capacity=args.pool,
                                        chunk_frames=args.chunk_frames,
                                        n_devices=n_devices)
        mode = (f"chunked x{args.chunk_frames}" if args.chunk_frames
                else "per-frame")
        print(f"[serve] pool({args.pool}, {mode}): {stats.n_requests} "
              f"sessions / {stats.total_frames} frames in {stats.wall_s:.2f}s "
              f"-> {stats.frames_per_s:.0f} frames/s, latency "
              f"p50 {stats.p50_latency_s*1e3:.0f} ms / "
              f"p95 {stats.p95_latency_s*1e3:.0f} ms")
        print(f"[serve] dispatch economy: {stats.n_dispatches} dispatches "
              f"({stats.dispatches_per_frame:.3f}/frame), host overlap "
              f"{stats.host_overlap_frac:.0%}")
        sp = stats.sparsity
        print(f"[serve] temporal sparsity {sp['temporal_sparsity']:.1%}, "
              f"weight sparsity {engine.weight_sparsity():.1%} "
              f"(pack overflow {engine.pack_overflow_count()} clipped), "
              f"overflow {sp['capacity_overflow_rate']:.1%}")
        rep = hw.evaluate_from_telemetry(hw.SPARTUS, hw.TEST_LAYER,
                                         args.gamma, sp)
        print(f"[serve] modelled Spartus latency at this sparsity: "
              f"{rep.latency_us:.2f} us "
              f"({rep.batch1_throughput_gops:.0f} GOp/s effective)")
        return

    engine = SpartusEngine(post.params, rcfg.model, ecfg, device=device)
    feats, *_ = next(SpeechDataset(cfg.data, 1))
    t0 = time.time()
    engine.run_utterance(feats[0].numpy()).cpu()
    dt = time.time() - t0
    sp = engine.measured_sparsity()
    print(f"[serve] streamed {feats.shape[1]} frames in {dt:.2f}s; "
          f"temporal sparsity {sp['temporal_sparsity']:.1%}, "
          f"weight sparsity {engine.weight_sparsity():.1%} "
          f"(pack overflow {engine.pack_overflow_count()} clipped), "
          f"overflow {sp['capacity_overflow_rate']:.1%}")
    rep = hw.evaluate_from_telemetry(hw.SPARTUS, hw.TEST_LAYER, args.gamma, sp)
    print(f"[serve] modelled Spartus latency for the paper's test layer at "
          f"this sparsity: {rep.latency_us:.2f} us "
          f"({rep.batch1_throughput_gops:.0f} GOp/s effective)")


def serve_spartus_async(args):
    """--async: the asyncio streaming front-end behind a localhost
    TCP/JSON-lines protocol (see the module docstring), plus optional
    in-process demo clients that stream utterances and print latency.

    Uses an untrained CBTD-pruned model (m=8) from seeded weights: the
    protocol/latency demo does not need trained weights.  At large
    ``--hidden`` such a network may never fire at the default theta, and
    then every logit is 0; the protocol still holds."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import QuantConfig
    from repro_torch.data.speech import SpeechConfig, SpeechDataset
    from repro_torch.models import lstm_am
    from repro_torch.serving import (
        AsyncSpartusServer, BatchedSpartusEngine, EngineConfig,
        PoolObservability, Tracer,
    )

    device = resolve_device(args.device)
    capacity = max(args.pool, 1)
    n_devices = pool_devices(args, device, capacity)
    data_cfg = SpeechConfig(max_frames=64)
    cfg = lstm_am.LSTMAMConfig(input_dim=data_cfg.feat_dim,
                               hidden_dim=args.hidden, n_layers=2,
                               n_classes=data_cfg.vocab)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                            device=device),
        gamma=args.gamma, m=8)
    engine = BatchedSpartusEngine(
        params, cfg, EngineConfig(theta=args.theta, gamma=args.gamma, m=8,
                                  quant=QuantConfig() if args.quant
                                  else None),
        device=device)
    chunk = args.chunk_frames or 8
    print(f"[serve] weight sparsity {engine.weight_sparsity():.1%} "
          f"(pack overflow {engine.pack_overflow_count()} clipped)")

    async def run():
        obs = PoolObservability(tracer=Tracer(enabled=bool(args.trace)))
        server = AsyncSpartusServer(
            engine, capacity, chunk_frames=chunk,
            target_chunk_ms=args.target_chunk_ms, max_frames=64,
            max_pending=4 * capacity,
            n_devices=n_devices,
            observability=obs,
            overload_policy=args.overload,
            idle_timeout_s=args.idle_timeout or None,
            watchdog=True)

        async def log_stats():
            while True:
                await asyncio.sleep(args.stats_interval)
                print(stats_line(server))

        admin = None
        logger = None
        async with server:
            tcp = await asyncio.start_server(
                lambda r, w: handle_conn(server, r, w),
                "127.0.0.1", args.port, limit=MAX_LINE_BYTES)
            port = tcp.sockets[0].getsockname()[1]
            mode = (f"{args.target_chunk_ms:.0f} ms/chunk paced"
                    if args.target_chunk_ms else "free-run")
            print(f"[serve] async Spartus server on 127.0.0.1:{port} "
                  f"(capacity {capacity}, {chunk}-frame chunks, {mode}, "
                  f"device {device})")
            try:
                if args.admin_port >= 0:
                    admin = await start_admin_server(server, obs,
                                                     port=args.admin_port)
                    aport = admin.sockets[0].getsockname()[1]
                    print(f"[serve] admin endpoint on 127.0.0.1:{aport} "
                          f"(healthz / stats / metrics / timeseries)")
                if args.stats_interval > 0:
                    logger = asyncio.create_task(log_stats())
                await run_clients(server, tcp, port)
            finally:
                if logger is not None:
                    logger.cancel()
                if admin is not None:
                    admin.close()
                    await admin.wait_closed()
                if args.trace:
                    obs.tracer.dump(args.trace)
                    print(f"[serve] wrote {obs.tracer.n_events} trace events "
                          f"to {args.trace} (load in Perfetto / "
                          f"chrome://tracing)")

    async def run_clients(server, tcp, port):
        if args.clients <= 0:
            print("[serve] serving forever (ctrl-c to stop) ...")
            async with tcp:
                await tcp.serve_forever()
            return
        n = args.clients
        data = SpeechDataset(data_cfg, n)
        feats, n_frames, *_ = next(data)
        utts = [feats[i, :max(int(n_frames[i]), 8)].numpy()
                for i in range(n)]
        out = await asyncio.gather(
            *[demo_client(port, i, utts[i]) for i in range(n)])
        tcp.close()
        await tcp.wait_closed()
        for cid, streamed, done in out:
            assert streamed.shape[0] == utts[cid].shape[0]
        stats = server.stats()
        print(f"[serve] {n} concurrent TCP clients served "
              f"{stats.total_frames} frames; per-client latency "
              f"p50 {stats.p50_latency_s*1e3:.0f} ms / "
              f"p95 {stats.p95_latency_s*1e3:.0f} ms, "
              f"first logit p50 {stats.p50_ttfl_s*1e3:.0f} ms, "
              f"queue wait p95 {stats.p95_queue_wait_s*1e3:.0f} ms")
        print(f"[serve] dispatch economy: {stats.n_dispatches} dispatches "
              f"({stats.dispatches_per_frame:.3f}/frame)")

    asyncio.run(run())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--spartus", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs on the host, the kernels' plain PyTorch "
                         "versions)")
    ap.add_argument("--theta", type=float, default=0.2)
    ap.add_argument("--gamma", type=float, default=0.75)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--quant", action="store_true",
                    help="serve with int8 CBCSC weight payloads and Q8.8 "
                         "delta thresholds")
    ap.add_argument("--pool", type=int, default=0,
                    help="session-pool capacity (0 = batch-1 engine; "
                         "--async uses >= 1)")
    ap.add_argument("--requests", type=int, default=16,
                    help="number of streaming requests for --pool mode")
    ap.add_argument("--chunk-frames", type=int, default=0,
                    help="frames advanced per device dispatch (0 = "
                         "per-frame ticks; --async defaults to 8)")
    ap.add_argument("--devices", type=int, default=0,
                    help="--pool/--async: shard the pool's slot dimension "
                         "over N devices (0 = one device, unsharded); "
                         "for now this shows placement only and lowers "
                         "throughput: every shard is dispatched from one "
                         "host thread")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="asyncio streaming front-end over localhost "
                         "TCP/JSON-lines (requires --spartus)")
    ap.add_argument("--port", type=int, default=0,
                    help="--async: TCP port (0 = ephemeral, printed)")
    ap.add_argument("--clients", type=int, default=8,
                    help="--async: in-process demo clients to run "
                         "(0 = serve forever)")
    ap.add_argument("--target-chunk-ms", type=float, default=0.0,
                    help="--async: wall-clock pacing per chunk boundary "
                         "(0 = free-run)")
    ap.add_argument("--admin-port", type=int, default=-1,
                    help="--async: open the read-only localhost admin "
                         "endpoint (healthz/stats/metrics/timeseries JSON "
                         "lines) on this port (0 = ephemeral, printed; "
                         "-1 = off)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="--async: log a one-line pool-health summary "
                         "every S seconds (0 = off)")
    ap.add_argument("--trace", default="",
                    help="--async: record driver-phase spans and write a "
                         "Chrome trace-event JSON here on shutdown "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--idle-timeout", type=float, default=0.0,
                    help="--async: reap sessions whose client is silent "
                         "for S seconds (typed retriable 'timeout' error; "
                         "0 = never)")
    ap.add_argument("--overload", choices=("wait", "shed"), default="wait",
                    help="--async: admission policy when max_pending "
                         "saturates — 'wait' queues the caller, 'shed' "
                         "answers a retriable typed error with a "
                         "retry_after_ms hint")
    args = ap.parse_args(argv)
    if args.async_mode and not args.spartus:
        ap.error("--async requires --spartus")
    if args.async_mode:
        mode = serve_spartus_async
    elif args.spartus:
        mode = serve_spartus
    else:
        mode = serve_arch
    try:
        mode(args)
    except RuntimeError as exc:
        if "CUDA" not in str(exc):
            raise
        sys.exit(f"serve: {exc} (on the launcher: --device cpu)")

if __name__ == "__main__":
    main()
