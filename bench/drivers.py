"""The loops that drive the program, one per kind of mix (``loop`` in
the mix's file): ``closed`` (clients that each send their next utterance
when the last one's result is back), ``open`` (streams that arrive on a
schedule and send their frames in blocks in real time) and ``paced``
(one stream on the batch-1 engine, one frame every ``frame_ms``).

Each returns a record of what the clients held and when, on the host
clock.  The window opens once the load is up (``warmup_s`` or
``ramp_s`` of it, counted in set-up) and lasts ``seconds``; ``hooks``
are told when it opens, at its thirds and when it closes.
"""
from __future__ import annotations

import asyncio
import itertools
import math
import time
from typing import Dict, List

import numpy as np

now = time.perf_counter


async def _sleep_until(t: float) -> None:
    delay = t - now()
    if delay > 0:
        await asyncio.sleep(delay)


async def _window(seconds: float, hooks) -> None:
    t0 = now()
    hooks.window_start(t0)
    for k in (1, 2):
        await _sleep_until(t0 + seconds * k / 3)
        hooks.segment(k, now())
    await _sleep_until(hooks.end_due(seconds))
    hooks.window_end(now())
    while hooks.retry_profile():
        await _sleep_until(hooks.end_due(seconds))
        hooks.window_end(now())


async def _prewarm(server, plan, n: int = 2, frames: int = 64) -> None:
    """A few utterances end to end before anything is timed: the first
    launch builds or loads the kernel library, and every kernel runs."""
    handles = []
    for uid in plan.order[:n]:
        handles.append(await server.stream(plan.feats[int(uid)][:frames],
                                           want_partials=True))
        handles[-1].close()
    for handle in handles:
        async for _ in handle:
            pass
        await handle.result()


async def closed_loop(server, plan, traffic: dict, seconds: float,
                      hooks) -> Dict:
    """``clients`` clients, each streaming one whole utterance at a time
    with partials on."""
    feats, order = plan.feats, plan.order
    picks = itertools.count()
    deliveries: List = []          # (t, rows) of every partial block held
    submitted: List[float] = []
    finished: List = []            # (utterance id, logits [T, C])
    live = set()
    state = {"stop": False, "errors": 0}

    async def client():
        while not state["stop"]:
            uid = int(order[next(picks) % len(order)])
            submitted.append(now())
            handle = await server.stream(feats[uid], want_partials=True)
            handle.close()
            live.add(handle)
            try:
                async for part in handle:
                    deliveries.append((now(), part.rows.shape[0]))
                result = await handle.result()
                finished.append((uid, result.logits))
            except asyncio.CancelledError:
                if not state["stop"]:
                    raise
            except Exception:        # a failed request counts; load goes on
                state["errors"] += 1
            finally:
                live.discard(handle)

    async with server:
        await _prewarm(server, plan)
        tasks = [asyncio.create_task(client())
                 for _ in range(traffic["clients"])]
        await asyncio.sleep(traffic["warmup_s"])
        await _window(seconds, hooks)
        state["stop"] = True
        for handle in list(live):
            handle.cancel()
        await asyncio.gather(*tasks)
    t0, t1 = hooks.t0, hooks.t1
    return {"deliveries": deliveries, "finished": finished,
            "attempted": sum(1 for t in submitted if t0 <= t < t1),
            "failed": state["errors"]}


async def open_loop(server, plan, traffic: dict, seconds: float,
                    hooks) -> Dict:
    """Streams open at the plan's arrival times; block k of a stream (its
    frames ``[bk, b(k+1))``) is due when its last frame is captured,
    ``frame_ms`` a frame after the stream opened.  A block's latency is
    from when it was due to when the client holds the logits of its last
    frame."""
    blk, frame_s = traffic["block_frames"], traffic["frame_ms"] * 1e-3
    feats = plan.feats
    latencies: List = []           # (due, latency) of every block held
    finished: List = []
    queue_waits: List = []         # (admitted at, wait)
    outstanding = {"n": 0, "errors": 0, "late": []}
    done = asyncio.Event()
    tasks, handles, backlog = [], [], {}

    def waiting() -> int:
        return sum(1 for h in handles if not h.admitted.is_set())

    async def stream(a: float, uid: int):
        x = feats[uid]
        t_len = x.shape[0]
        n_blocks = math.ceil(t_len / blk)
        ends = [min(blk * (k + 1), t_len) for k in range(n_blocks)]
        dues = [a + frame_s * e for e in ends]
        mine = sum(1 for d in dues if t0 <= d < t1)
        outstanding["n"] += mine
        outstanding["late"].append(now() - a)
        handle = await server.stream(want_partials=True)
        handles.append(handle)
        rows: List[np.ndarray] = []

        async def consume():
            nonlocal mine
            k = 0
            async for part in handle:
                held = now()
                rows.append(part.rows)
                hi = part.t0 + part.rows.shape[0]
                while k < n_blocks and ends[k] <= hi:
                    if t0 <= dues[k] < t1:
                        latencies.append((dues[k], held - dues[k]))
                        mine -= 1
                        outstanding["n"] -= 1
                    k += 1
                if outstanding["n"] == 0 and now() >= t1:
                    done.set()

        reader = asyncio.create_task(consume())
        try:
            for k in range(n_blocks):
                await _sleep_until(dues[k])
                await handle.send(x[blk * k:ends[k]])
            handle.close()
            await reader
            result = await handle.result()
            got = np.concatenate(rows) if rows else np.zeros((0, 1))
            finished.append((uid, got))
            queue_waits.append((a + result.queue_wait_s,
                                result.queue_wait_s))
        except asyncio.CancelledError:
            # the load is over: the stream is abandoned, not failed
            handle.cancel()
            reader.cancel()
            outstanding["n"] -= mine
            if not outstanding.get("stop"):
                raise
        except Exception:
            outstanding["errors"] += 1
            outstanding["n"] -= mine

    async with server:
        await _prewarm(server, plan)
        base = now() + 0.05
        t0 = base + traffic["ramp_s"]
        t1 = t0 + seconds

        async def arrive():
            for a, uid in zip(plan.arrivals, plan.order):
                t = base + float(a)
                await _sleep_until(t)
                tasks.append(asyncio.create_task(stream(t, int(uid))))

        arrivals = asyncio.create_task(arrive())
        await _sleep_until(t0)
        backlog["start"] = waiting()
        await _window(seconds, hooks)
        backlog["end"] = waiting()
        await arrivals
        if outstanding["n"] > 0:
            try:
                await asyncio.wait_for(done.wait(), timeout=60.0)
            except asyncio.TimeoutError:
                pass
        unanswered = max(outstanding["n"], 0)
        outstanding["stop"] = True
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    arrived = [a for a in plan.arrivals if t0 <= base + a < t1]
    return {"latencies": [lat for due, lat in latencies],
            "finished": finished,
            "queue_waits": queue_waits,
            "attempted": len(arrived),
            "failed": outstanding["errors"] + unanswered,
            "open_late_s": float(np.max(outstanding["late"]))
            if outstanding["late"] else 0.0,
            "backlog": backlog}


def _wait_until(t: float) -> None:
    """Spin until ``t``: a paced frame is sent when it is due, not when
    the scheduler wakes the thread, and from a core that did not sleep
    (a sleeping client's wake-up jitter widened batch-1 tails on an
    H100 host)."""
    while now() < t:
        pass


def paced(engine, plan, traffic: dict, seconds: float, hooks,
          device, spans=None) -> Dict:
    """One client on the batch-1 engine: utterances back to back, a new
    session each, frame j due ``frame_ms * j`` after the start; each
    frame's logits are taken to the host as they come."""
    import torch

    frame_s = traffic["frame_ms"] * 1e-3
    first = plan.feats[int(plan.order[0])]
    engine.run_utterance(first[:32]).cpu()   # builds or loads the kernels
    base = now() + 0.01
    t0 = base + traffic["warmup_s"]
    t1 = t0 + seconds
    latencies, finished = [], []
    j = 0
    marks = iter([(t0, hooks.window_start),
                  (t0 + seconds / 3, lambda t: hooks.segment(1, t)),
                  (t0 + seconds * 2 / 3, lambda t: hooks.segment(2, t))])
    mark = next(marks)
    attempted = 0
    for uid in plan.order:
        x = plan.feats[int(uid)]
        session = engine.new_session()
        rows = []
        for t in range(x.shape[0]):
            due = base + frame_s * j
            j += 1
            if due >= t1:
                break
            while mark is not None and due >= mark[0]:
                mark[1](now())
                mark = next(marks, None)
            if spans is not None:
                with spans.span("batch1.pacing"):
                    _wait_until(due)
            else:
                _wait_until(due)
            if spans is not None:
                with spans.span("batch1.step"):
                    out = engine.step(session, torch.from_numpy(x[t]).to(
                        device)).cpu()
            else:
                out = engine.step(session, torch.from_numpy(x[t]).to(
                    device)).cpu()
            held = now()
            if due >= t0:
                attempted += 1
                latencies.append(held - due)
            rows.append(out.numpy())
        else:
            finished.append((int(uid), np.stack(rows)))
            continue
        break
    hooks.window_end(now())
    return {"latencies": latencies, "finished": finished,
            "attempted": attempted, "failed": 0}
