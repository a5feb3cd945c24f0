"""Asyncio streaming front-end over the chunked session pool — port of
``repro/serving/async_server.py``.

`serve_requests` (scheduler.py) is a synchronous drain loop: the full
request list is known up front, the driver owns the thread until every
utterance completes, and logits surface only at retirement.  Real online
speech serving (the Spartus target: ~1 us/frame streaming inference) is
the opposite shape — clients connect at arbitrary times, frames arrive
incrementally as audio is captured, and the decoder downstream wants
logits *as they are produced*, not after the utterance ends.

`AsyncSpartusServer` is that front-end, built directly on the
`SessionPool` primitives (`admit_stream`/`append_frames`/`tick`/
`take_partials`):

* **Clients** call ``await server.submit(feats)`` for a whole utterance,
  or ``await server.stream()`` for a `StreamHandle` they feed
  incrementally (``await h.send(frames)`` ... ``h.close()``) — or hand an
  async iterator of frame blocks to ``submit_stream``.  Partial logits
  stream back per chunk through the handle's `asyncio.Queue`
  (``async for rows in handle``); the final `RequestResult` resolves the
  handle's future.  ``h.cancel()`` abandons the utterance mid-stream and
  frees the slot at the next chunk boundary.
* **One background driver task** owns the pool.  Each iteration it moves
  client-buffered frames into the pool (admissions, appends, finishes,
  cancellations — all staged host-side, so client coroutines never touch
  device state), runs ONE ``pool.tick`` (at most one chunk dispatch,
  double-buffered exactly like the sync path), delivers the resolved
  partials/results to the per-client queues, and then sleeps until the
  next wall-clock chunk boundary (``target_chunk_ms``; 0 = free-run).
  With ``offload_ticks=True`` the tick runs in a worker thread so the
  event loop keeps serving client sends during the device sync.
* **Backpressure**: at most ``max_pending`` clients may sit in the
  admission queue; further ``submit``/``stream`` calls *await* until a
  slot train frees, so a load spike queues at the front door instead of
  growing unbounded host state.  Queue-wait and time-to-first-logit
  surface per request and as p50/p95/p99 in ``server.stats()``.
* **Bounded partial-logit queues**: each session's partials queue holds
  at most ``partial_queue_len`` blocks.  The driver never blocks on a
  slow consumer — when a queue is full the session is marked *lagging*:
  its per-chunk snapshots pause (`SessionPool.pause_partials`), nothing
  further is buffered host-side for it, and when the client drains the
  gap is recovered in ONE catch-up copy from the device logits bank
  (`SessionPool.backfill_partials`; the bank holds the whole utterance
  until retirement anyway), staged at one boundary and delivered at
  the next, ahead of the session's later blocks.  A client that never
  drains costs a bounded queue plus its (already-allocated) slot —
  previously one stalled client accumulated every ``[C, n_classes]``
  block of its stream forever.

The streamed rows are the synchronous path's: the driver runs the very
same chunked `step_chunk` dispatch, so ``concat(partials) ==
result.logits`` bit for bit and ``== serve_requests(...)`` at 1e-5.

On a card, ``offload_ticks`` runs the tick in a worker thread whose
CUDA device and current stream are set, by the executor's initializer,
to the ones the server was started on: the kernels launch on PyTorch's
current stream, and the copies the loop thread stages (the backfill)
must follow the same stream's order.  No coroutine here syncs with the
device: ``stats()`` reads the telemetry copy the pool staged behind its
last chunk (`SessionPool.staged_sparsity`), and only the tick, in its
worker, waits, and only on the previous chunk's staged copies.  (The
watchdog's recovery is the one deliberate exception: it stalls the
loop while it rebuilds the pool.)
"""
from __future__ import annotations

import asyncio
import itertools
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Deque, Dict, List, Optional

import numpy as np

import torch

from repro_torch.serving.batched_engine import BatchedSpartusEngine
from repro_torch.serving.faults import (
    AdmissionShed,
    BadRequest,
    DriverRecovered,
    FaultInjector,
    InjectedFault,
    SessionTimeout,
)
from repro_torch.serving.metrics import NULL_TRACER, PoolObservability
from repro_torch.serving.scheduler import (
    PartialLogits,
    RequestResult,
    ServeStats,
    SessionPool,
    aggregate_stats,
)

_EOS = object()   # end-of-stream sentinel on a handle's partials queue


class StreamClosed(RuntimeError):
    """Raised when sending frames to a closed or cancelled stream."""


class _ClientState:
    """Driver-side bookkeeping for one connected stream (loop thread only:
    clients buffer frames here; the driver moves them into the pool at
    chunk boundaries, so no client coroutine ever touches device state)."""

    __slots__ = ("req_id", "handle", "arrival_wall", "want_partials",
                 "buffered", "closed", "cancelled", "admitted",
                 "finish_sent", "delivered_t", "lagging", "backfill_hi",
                 "token", "last_activity")

    def __init__(self, req_id: int, handle: "StreamHandle",
                 arrival_wall: float, want_partials: bool,
                 token: Optional[str] = None):
        self.req_id = req_id
        self.handle = handle
        self.arrival_wall = arrival_wall
        self.want_partials = want_partials
        self.buffered: List[np.ndarray] = []
        self.closed = False
        self.cancelled = False
        self.admitted = False
        self.finish_sent = False
        self.delivered_t = 0      # frames enqueued on the partials queue
        self.lagging = False      # queue hit partial_queue_len: snapshots
        #                           paused until the client drains
        self.backfill_hi = 0      # end of the last backfill staged
        self.token = token        # idempotent re-admission token
        self.last_activity = arrival_wall   # idle-reaper clock


class StreamHandle:
    """Client-side handle to one streaming session.

    ``await send(frames)`` feeds more frames (any ``[n, D]`` block);
    ``close()`` marks the utterance complete; ``async for rows in handle``
    yields per-chunk partial logits (``PartialLogits``) until the stream
    ends; ``await result()`` returns the final `RequestResult` (its
    ``logits`` equal the concatenated partials).  ``cancel()`` abandons
    the utterance — ``result()`` then raises `asyncio.CancelledError` and
    the partials iterator stops.
    """

    def __init__(self, server: "AsyncSpartusServer", req_id: int):
        self._server = server
        self.req_id = req_id
        self._partials: asyncio.Queue = asyncio.Queue()
        self._result: asyncio.Future = (
            asyncio.get_running_loop().create_future())
        self._feed_task: Optional[asyncio.Task] = None  # submit_stream pump
        #: set once the session holds a pool slot (backpressure observability)
        self.admitted = asyncio.Event()

    async def send(self, frames: np.ndarray) -> None:
        """Feed one block of frames ``[n, D]`` (or a single frame ``[D]``).

        Sends only buffer host-side and set the driver's wake event —
        they do NOT yield per call (the old per-send ``sleep(0)`` poke
        context-switched into the driver once per client send; the driver
        drains every client's buffered ops in one batched pump per chunk
        boundary instead)."""
        self._server._client_send(self.req_id, frames)

    def close(self) -> None:
        """No more frames: the session retires once everything fed has
        been consumed."""
        self._server._client_close(self.req_id)

    def cancel(self) -> None:
        """Abandon the utterance; the slot frees at the next boundary."""
        self._server._client_cancel(self.req_id)

    async def result(self) -> RequestResult:
        """The final `RequestResult` (raises `asyncio.CancelledError` if
        the stream was cancelled)."""
        return await asyncio.shield(self._result)

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> PartialLogits:
        item = await self._partials.get()
        # a lagging (slow-consumer) session's snapshots are paused; tell
        # the driver we drained so it can backfill + resume even if it is
        # otherwise idle (no-op for healthy sessions):
        self._server._note_drain(self.req_id)
        if item is _EOS:
            raise StopAsyncIteration
        return item


class AsyncSpartusServer:
    """Admission-while-running streaming server over one
    `BatchedSpartusEngine`.

    Parameters
    ----------
    engine / capacity / chunk_frames / max_frames / max_buffer_frames:
        forwarded to the underlying `SessionPool` (``chunk_frames >= 1``
        selects the chunked tick loop; the pool streams per-chunk partial
        logits).
    target_chunk_ms:
        wall-clock pacing of chunk boundaries: the driver sleeps out the
        remainder of this budget after each tick, so a chunk's worth of
        frames is consumed per period (real-time streaming). ``0`` =
        free-run (throughput mode: tick as fast as the device allows).
    max_pending:
        admission-queue bound: at most this many clients wait for a slot;
        further ``submit``/``stream`` calls await (backpressure).
        ``None`` = unbounded (open-loop load generation).
    partial_queue_len:
        per-session bound on buffered partial-logit blocks (the
        slow-consumer fix): when a client stops draining its queue, the
        driver marks the session lagging, pauses its per-chunk snapshots
        and buffers nothing more for it — the skipped range is recovered
        from the device logits bank in one fetch when the client drains
        (or arrives with the final result).  The driver never blocks and
        healthy sessions are unaffected.  ``None`` = the default bound
        (32); ``0`` = unbounded (the pre-fix behaviour, load-gen only).
    offload_ticks:
        run each ``pool.tick`` in a one-thread executor so the event loop
        stays responsive (client sends land mid-chunk) — the pool is only
        ever touched by one thread at a time, since the driver awaits the
        tick before pumping again.  ``False`` keeps ticks on the loop
        (slightly less overhead; fine when clients batch their sends).
    n_devices:
        shard the pool's slot dimension over N devices
        (`SessionPool(n_devices=...)`, `serving/sharding.py`); ``None`` =
        one shard on the engine's device.  The watchdog rebuilds a
        sharded pool from the same kwargs.
    observability:
        a `PoolObservability` (serving/metrics.py): the pool folds every
        chunk boundary into its registry/ring buffer, and the driver
        amends each boundary's sample with loop-side signals (lagging
        consumers, partial-queue depth, connected streams) and traces the
        delivery/pacing phases.  Thread-safe with ``offload_ticks`` (the
        registry and ring lock internally).  ``None`` = fully off.
    overload_policy:
        what happens when the admission queue (``max_pending``) is full:
        ``"wait"`` (default) blocks the caller until a slot frees — the
        pre-robustness behaviour; ``"shed"`` raises `AdmissionShed`
        immediately (retriable, with a ``retry_after_ms`` hint) so the
        caller's backpressure is explicit and bounded-latency.
    idle_timeout_s:
        reap sessions whose client has gone silent (no send/close) for
        this many wall-clock seconds: the slot frees and the client's
        handle fails with `SessionTimeout` (retriable).  ``None`` = never.
    watchdog:
        catch a crashed tick loop instead of failing every client: the
        driver snapshots the salvageable sessions (serving/checkpoint.py),
        rebuilds the pool, restores them and resumes.  Only sessions whose
        state is unrecoverable fail — with `DriverRecovered` (retriable) —
        everyone else continues bit-identically.  ``max_recoveries`` caps
        successive rebuilds; past it the driver fails loudly as before.
    faults:
        a `FaultInjector` threaded into the pool — deterministic chaos
        for the robustness tests.  ``None`` in
        production.
    """

    DEFAULT_PARTIAL_QUEUE_LEN = 32

    def __init__(self, engine: BatchedSpartusEngine, capacity: int, *,
                 chunk_frames: int = 8, target_chunk_ms: float = 0.0,
                 max_pending: Optional[int] = None, max_frames: int = 64,
                 max_buffer_frames: Optional[int] = None,
                 partial_queue_len: Optional[int] = None,
                 offload_ticks: bool = True,
                 n_devices: Optional[int] = None,
                 observability: Optional[PoolObservability] = None,
                 overload_policy: str = "wait",
                 idle_timeout_s: Optional[float] = None,
                 watchdog: bool = False,
                 max_recoveries: int = 8,
                 faults: Optional[FaultInjector] = None):
        if chunk_frames < 1:
            raise ValueError("AsyncSpartusServer requires chunk_frames >= 1 "
                             "(the per-chunk partial-logits contract)")
        if overload_policy not in ("wait", "shed"):
            raise ValueError(f"overload_policy must be 'wait' or 'shed', "
                             f"got {overload_policy!r}")
        self.obs = observability
        self._tracer = (observability.tracer if observability is not None
                        else NULL_TRACER)
        self._engine = engine
        # the watchdog rebuilds the pool from these exact kwargs (modulo
        # max_frames, which tracks the live pool's grown buffer bucket):
        self._pool_kwargs = dict(
            max_frames=max_frames, chunk_frames=chunk_frames,
            max_buffer_frames=max_buffer_frames, stream_partials=True,
            n_devices=n_devices, observability=observability, faults=faults)
        self.pool = SessionPool(engine, capacity, **self._pool_kwargs)
        self.capacity = capacity
        self.overload_policy = overload_policy
        self.idle_timeout_s = idle_timeout_s
        self.watchdog = watchdog
        self.max_recoveries = max_recoveries
        self.n_recoveries = 0
        self._tokens: Dict[str, StreamHandle] = {}
        self.chunk_frames = chunk_frames
        self.target_chunk_s = target_chunk_ms * 1e-3
        self.max_pending = max_pending
        self.partial_queue_len = (self.DEFAULT_PARTIAL_QUEUE_LEN
                                  if partial_queue_len is None
                                  else max(int(partial_queue_len), 0))
        self._sem = (asyncio.Semaphore(max_pending)
                     if max_pending is not None else None)
        self._offload = offload_ticks
        self._exec: Optional[ThreadPoolExecutor] = None
        self._ids = itertools.count()
        self._clients: Dict[int, _ClientState] = {}
        self._waiting: Deque[_ClientState] = deque()
        # batched-pump bookkeeping: only clients with buffered ops are
        # visited per boundary (the pump used to scan every client every
        # iteration), and the partial-snapshot toggle is a counter, not
        # an any() sweep:
        self._dirty: set = set()
        self._lagging: set = set()
        self._n_partial_subs = 0
        self._wake: Optional[asyncio.Event] = None
        self._driver: Optional[asyncio.Task] = None
        self._stopping = False
        self.now = 0            # scheduler tick clock (frames granularity)
        self._steps = 0         # ticks that advanced >= 1 slot (flush-only
        #                         iterations excluded, like serve_requests)
        self._completed: List[RequestResult] = []
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._driver is not None:
            raise RuntimeError("server already started")
        self._wake = asyncio.Event()
        if self._offload:
            dev, stream = self._engine.device, None
            if dev.type == "cuda":
                # the worker is bound to this thread's card and stream
                stream = torch.cuda.current_stream(dev)
            self._exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="spartus-tick",
                initializer=_bind_device, initargs=(dev, stream))
        self._stopping = False
        self._t_start = time.perf_counter()
        self._driver = asyncio.create_task(self._drive(), name="spartus-drive")

    async def stop(self) -> None:
        """Drain: waits for every connected stream to finish (clients must
        ``close()`` or ``cancel()`` their streams), then stops the driver."""
        if self._driver is None:
            return
        self._stopping = True
        self._wake.set()
        try:
            await self._driver
        finally:
            self._driver = None
            if self._exec is not None:
                self._exec.shutdown(wait=False)
                self._exec = None

    async def __aenter__(self) -> "AsyncSpartusServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- client API ----------------------------------------------------------

    async def stream(self, feats: Optional[np.ndarray] = None, *,
                     want_partials: bool = True,
                     token: Optional[str] = None) -> StreamHandle:
        """Open a streaming session; under the default ``"wait"`` overload
        policy this awaits while the admission queue is full
        (backpressure); under ``"shed"`` it raises `AdmissionShed` instead.
        ``feats`` optionally seeds initial frames.  ``token`` makes the
        open idempotent: re-opening with a token that already names a live
        stream returns the SAME handle, so a client retrying after a
        dropped ack cannot double-admit its utterance."""
        if self._driver is None:
            raise RuntimeError("server is not started")
        if self._stopping:
            raise RuntimeError("server is stopping")
        if token is not None:
            existing = self._tokens.get(token)
            if existing is not None:
                return existing           # idempotent re-open
        arrival_wall = time.perf_counter()
        if feats is not None:
            # validate BEFORE anything is enqueued: a bad request must be
            # a per-request error, never a poisoned admission the driver
            # trips over later.
            feats = self._validated(feats)
        if self._sem is not None:
            if self.overload_policy == "shed" and self._sem.locked():
                if self.obs is not None:
                    self.obs.fold_shed()
                raise AdmissionShed(retry_after_ms=max(
                    self.target_chunk_s * 1e3, 50.0))
            await self._sem.acquire()     # <- the admission-queue bound
        req_id = next(self._ids)
        handle = StreamHandle(self, req_id)
        cs = _ClientState(req_id, handle, arrival_wall, want_partials,
                          token=token)
        if feats is not None:
            cs.buffered.append(feats)
        self._clients[req_id] = cs
        self._waiting.append(cs)
        if token is not None:
            self._tokens[token] = handle
        if want_partials:
            self._n_partial_subs += 1
        self._wake.set()
        return handle

    async def submit(self, feats: np.ndarray, *,
                     want_partials: bool = False) -> RequestResult:
        """Serve one complete utterance and await its result (the simplest
        client: no incremental feeding, partials off by default)."""
        handle = await self.stream(feats, want_partials=want_partials)
        handle.close()
        return await handle.result()

    async def submit_stream(
        self, blocks: AsyncIterator[np.ndarray], *,
        want_partials: bool = True,
    ) -> StreamHandle:
        """Open a session fed from an async iterator of frame blocks (a
        background task pumps it and closes the stream at exhaustion)."""
        handle = await self.stream(want_partials=want_partials)

        async def pump() -> None:
            try:
                async for block in blocks:
                    await handle.send(block)
                handle.close()
            except asyncio.CancelledError:
                handle.cancel()
                raise

        # keep a strong reference: the loop only holds tasks weakly, and a
        # GC'd feeder would silently starve the stream.
        handle._feed_task = asyncio.create_task(
            pump(), name=f"spartus-feed-{handle.req_id}")
        return handle

    # client ops are plain buffer writes on the loop thread; the driver
    # moves them into the pool at the next boundary:

    def _validated(self, frames: np.ndarray, already: int = 0) -> np.ndarray:
        """Shape/dim/dtype/finiteness/size checks at the client boundary,
        so malformed input raises in the offending client's call — as a
        typed `BadRequest` — and can never reach the pool (where it would
        crash the shared driver or, worse, poison a neighbour's chunk)."""
        try:
            arr = np.asarray(frames)
            if arr.dtype.kind not in "fiu":
                raise BadRequest(
                    f"frames have unsupported dtype {arr.dtype} "
                    f"(expected a float or integer array)")
            block = _as_frames(arr)
            if block.shape[-1] != self.pool.engine.input_dim:
                raise BadRequest(
                    f"frames must have feature dim "
                    f"{self.pool.engine.input_dim}, got {block.shape[-1]}")
            if not np.isfinite(block).all():
                raise BadRequest("frames contain NaN/Inf values")
            if already + block.shape[0] > self.pool.max_buffer_frames:
                raise BadRequest(
                    f"{already + block.shape[0]} frames would exceed the "
                    f"frame-buffer growth limit (max_buffer_frames="
                    f"{self.pool.max_buffer_frames})")
        except BadRequest:
            if self.obs is not None:
                self.obs.fold_bad_request()
            raise
        except ValueError as exc:       # _as_frames' shape complaint
            if self.obs is not None:
                self.obs.fold_bad_request()
            raise BadRequest(str(exc)) from exc
        return block

    def _client_send(self, req_id: int, frames: np.ndarray) -> None:
        cs = self._clients.get(req_id)
        if cs is None or cs.closed or cs.cancelled:
            raise StreamClosed(f"stream {req_id} is closed")
        in_pool = cs.admitted and req_id in self.pool._by_req
        already = (sum(b.shape[0] for b in cs.buffered)
                   + (self.pool._live(req_id).n_recv if in_pool else 0))
        cs.buffered.append(self._validated(frames, already))
        cs.last_activity = time.perf_counter()
        self._dirty.add(req_id)
        self._wake.set()

    def _client_close(self, req_id: int) -> None:
        cs = self._clients.get(req_id)
        if cs is None or cs.cancelled:
            return
        cs.closed = True
        cs.last_activity = time.perf_counter()
        self._dirty.add(req_id)
        self._wake.set()

    def _client_cancel(self, req_id: int) -> None:
        cs = self._clients.get(req_id)
        if cs is None or cs.cancelled:
            return
        cs.cancelled = True
        self._dirty.add(req_id)
        self._wake.set()

    def _note_drain(self, req_id: int) -> None:
        """A consumer took an item off its partials queue: if its session
        is lagging, wake the driver so `_service_lagging` can backfill
        and resume it even when the pool is otherwise idle."""
        if req_id in self._lagging and self._wake is not None:
            self._wake.set()

    # -- driver --------------------------------------------------------------

    def _pump(self) -> None:
        """Move client state into the pool (driver only, between ticks):
        admissions for waiting clients while slots are free, then frame
        appends / finishes / cancellations for the clients that actually
        changed since the last boundary (the dirty set) — one batched
        pass per chunk boundary instead of an every-client scan."""
        pool = self.pool
        # partial snapshots cost a per-chunk [B, C, n_classes] copy+fetch;
        # skip them entirely while nobody subscribed (pure-submit load).
        # Counter-maintained: the any()-over-clients sweep this replaces
        # was per-iteration O(clients):
        pool.stream_partials = self._n_partial_subs > 0
        # clients cancelled while still queued need no slot to settle:
        if self._waiting and any(cs.cancelled for cs in self._waiting):
            for cs in [c for c in self._waiting if c.cancelled]:
                self._waiting.remove(cs)
                self._settle_cancel(cs)
        while self._waiting and pool.n_free:
            cs = self._waiting[0]
            if cs.cancelled:
                self._waiting.popleft()
                self._settle_cancel(cs)
                continue
            feats = _concat(cs.buffered)
            cs.buffered.clear()
            try:
                admitted = pool.admit_stream(cs.req_id, self.now,
                                             feats=feats,
                                             arrival_wall=cs.arrival_wall)
            except Exception as exc:        # a bad request fails ITSELF,
                self._waiting.popleft()     # never the shared driver
                self._settle_error(cs, exc)
                continue
            if not admitted:
                break                       # raced a slot; retry next tick
            self._waiting.popleft()
            cs.admitted = True
            cs.handle.admitted.set()
            if self._sem is not None:
                self._sem.release()
            if cs.closed:
                pool.finish_stream(cs.req_id)
                cs.finish_sent = True
        dirty, self._dirty = self._dirty, set()
        for req_id in sorted(dirty):
            cs = self._clients.get(req_id)
            if cs is None or not cs.admitted:
                continue   # settled, or still waiting (its buffered ops
                #            ride along at admission time)
            if cs.cancelled:
                # the session may be live OR already inside the
                # retirement window (finished, host fetch outstanding):
                # pool.cancel covers both, suppressing the result at
                # resolve time so no stale logits are ever delivered.
                try:
                    pool.cancel(req_id)
                except KeyError:
                    pass                    # already fully resolved
                self._settle_cancel(cs)
                continue
            try:
                if cs.buffered:
                    pool.append_frames(req_id, _concat(cs.buffered))
                    cs.buffered.clear()
                if cs.closed and not cs.finish_sent:
                    pool.finish_stream(req_id)
                    cs.finish_sent = True
            except Exception as exc:
                try:
                    pool.cancel(req_id)
                except KeyError:
                    pass
                self._settle_error(cs, exc)

    def _forget(self, cs: _ClientState) -> None:
        """Drop driver-side bookkeeping for a client leaving the server."""
        self._dirty.discard(cs.req_id)
        self._lagging.discard(cs.req_id)
        if cs.token is not None:
            self._tokens.pop(cs.token, None)
        if cs.want_partials:
            self._n_partial_subs -= 1

    def _settle_cancel(self, cs: _ClientState) -> None:
        del self._clients[cs.req_id]
        self._forget(cs)
        if not cs.admitted and self._sem is not None:
            self._sem.release()
        cs.handle._partials.put_nowait(_EOS)
        if not cs.handle._result.done():
            cs.handle._result.cancel()

    def _settle_error(self, cs: _ClientState, exc: Exception) -> None:
        """Fail ONE client's handle with its own error (driver stays up)."""
        self._clients.pop(cs.req_id, None)
        self._forget(cs)
        if not cs.admitted and self._sem is not None:
            self._sem.release()
        cs.handle._partials.put_nowait(_EOS)
        if not cs.handle._result.done():
            cs.handle._result.set_exception(exc)

    def _push_partial(self, cs: _ClientState, t0: int,
                      rows: np.ndarray) -> None:
        """Enqueue one partial block, bounded: trim anything a backfill
        already covered, and on a full queue mark the session lagging —
        pause its pool-side snapshots, buffer nothing (the skipped rows
        stay in the device logits bank until the client drains).  A block
        that starts past what was delivered would leave a hole: it is
        dropped too, and a backfill delivers its rows in order — the one
        already staged when it covers them, else a new one."""
        n = rows.shape[0]
        if t0 + n <= cs.delivered_t:
            return                       # backfill already covered it
        if t0 < cs.delivered_t:          # partial overlap after a backfill
            rows = rows[cs.delivered_t - t0:]
            t0 = cs.delivered_t
        if t0 > cs.delivered_t and t0 + n <= cs.backfill_hi:
            return                       # the staged backfill carries it
        q = cs.handle._partials
        if t0 > cs.delivered_t or (self.partial_queue_len and
                                   q.qsize() >= self.partial_queue_len):
            if not cs.lagging:
                cs.lagging = True
                self._lagging.add(cs.req_id)
                try:
                    self.pool.pause_partials(cs.req_id)
                except KeyError:
                    pass                 # retired already; the final
                    #                      result carries the tail
            return
        q.put_nowait(PartialLogits(req_id=cs.req_id, t0=t0, rows=rows))
        cs.delivered_t = t0 + rows.shape[0]

    def _service_lagging(self) -> None:
        """Resume sessions whose slow consumer drained below the bound:
        stage the skipped range in ONE catch-up copy from the device
        logits bank, delivered at the next boundary ahead of the
        session's later blocks, and re-enable their per-chunk snapshots.
        Nothing here waits on the device."""
        if not self._lagging:
            return
        for req_id in sorted(self._lagging):
            cs = self._clients.get(req_id)
            if cs is None:
                self._lagging.discard(req_id)
                continue
            q = cs.handle._partials
            if self.partial_queue_len and \
                    q.qsize() >= self.partial_queue_len:
                continue                 # still stalled
            if req_id in self.pool._by_req:
                cs.backfill_hi = cs.delivered_t + self.pool.backfill_partials(
                    req_id, cs.delivered_t)
            cs.lagging = False
            self._lagging.discard(req_id)

    def _deliver(self, partials: List[PartialLogits],
                 finished: List[RequestResult]) -> None:
        """One batched delivery pass per chunk boundary: every partial
        block and result lands on its client's queue/future here (the
        waiting tasks' wakeups are then scheduled together by the event
        loop, instead of interleaving per-session pokes with pool work)."""
        for p in partials:
            cs = self._clients.get(p.req_id)
            if cs is not None and cs.want_partials:
                self._push_partial(cs, p.t0, p.rows)
        if not finished:
            return
        self._t_last = time.perf_counter()   # one clock read per boundary
        for r in finished:
            self._completed.append(r)
            cs = self._clients.pop(r.req_id, None)
            if cs is None:
                continue
            self._forget(cs)
            if cs.want_partials and cs.delivered_t < r.logits.shape[0]:
                # lagging tail: the queue bound skipped blocks that never
                # got a drain; the result rows are host-side already, so
                # the catch-up block is one slice, not a device fetch.
                cs.handle._partials.put_nowait(PartialLogits(
                    req_id=r.req_id, t0=cs.delivered_t,
                    rows=r.logits[cs.delivered_t:]))
                cs.delivered_t = r.logits.shape[0]
            cs.handle._partials.put_nowait(_EOS)
            if not cs.handle._result.done():
                cs.handle._result.set_result(r)

    def _has_work(self) -> bool:
        pool = self.pool
        return (pool.max_chunk_advance() > 0 or pool.has_pending
                or pool.has_retirable
                or bool(self._waiting and pool.n_free))

    async def _drive(self) -> None:
        try:
            await self._drive_loop()
        except Exception as exc:
            # fail loudly: every connected client sees the driver's error
            # instead of hanging on a queue that will never fill.
            for cs in list(self._clients.values()):
                cs.handle._partials.put_nowait(_EOS)
                if not cs.handle._result.done():
                    cs.handle._result.set_exception(exc)
            self._clients.clear()
            self._waiting.clear()
            raise

    async def _drive_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # re-read the pool EVERY iteration: the watchdog swaps it out
            # under our feet on recovery, and a cached local would tick a
            # dead pool forever.
            pool = self.pool
            self._wake.clear()
            self._pump()
            self._service_lagging()
            self._reap_idle()
            if not self._has_work():
                if self._stopping and not self._clients and \
                        not self._waiting:
                    break
                if self.idle_timeout_s is not None:
                    # poll so the reaper runs even with zero client
                    # activity (a wholly silent fleet still times out):
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(),
                            timeout=max(self.idle_timeout_s / 4, 0.01))
                    except asyncio.TimeoutError:
                        pass
                else:
                    await self._wake.wait()
                continue
            t0 = loop.time()
            try:
                if self._exec is not None:
                    finished, adv = await loop.run_in_executor(
                        self._exec, pool.tick, self.now)
                else:
                    finished, adv = pool.tick(self.now)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if not self.watchdog or \
                        self.n_recoveries >= self.max_recoveries:
                    raise       # -> _drive fails every client, loudly
                finished, adv = self._recover(exc)
            self.now += max(adv, 1)
            self._steps += adv
            with self._tracer.span("delivery_pump"):
                self._deliver(self.pool.take_partials(), finished)
            if self.obs is not None:
                self._fold_loop_side(dispatched=adv > 0)
            with self._tracer.span("pacing_idle"):
                if self.target_chunk_s > 0.0:
                    # wall-clock-paced boundaries: one chunk per period;
                    # the sleep is where client coroutines get the loop.
                    delay = self.target_chunk_s - (loop.time() - t0)
                    await asyncio.sleep(delay if delay > 0 else 0)
                else:
                    await asyncio.sleep(0)  # free-run, but stay preemptible

    # -- robustness ----------------------------------------------------------

    def _reap_idle(self) -> None:
        """Cancel sessions whose client has gone silent past
        ``idle_timeout_s`` — the slot frees, the handle fails with a
        retriable `SessionTimeout`.  Closed streams are exempt: their
        client finished sending and is legitimately waiting on the pool."""
        if self.idle_timeout_s is None or not self._clients:
            return
        now = time.perf_counter()
        for cs in list(self._clients.values()):
            if cs.closed or cs.cancelled:
                continue
            if now - cs.last_activity < self.idle_timeout_s:
                continue
            if cs.admitted:
                try:
                    self.pool.cancel(cs.req_id)
                except KeyError:
                    pass                 # already resolving
            else:
                try:
                    self._waiting.remove(cs)
                except ValueError:
                    pass
            if self.obs is not None:
                self.obs.fold_timeouts(1)
            self._settle_error(cs, SessionTimeout(
                f"session {cs.req_id} idle for >= {self.idle_timeout_s}s"))

    def _recover(self, exc: Exception):
        """Watchdog: the tick raised.  Salvage every session the device
        state still covers (serving/checkpoint.py snapshot), rebuild the
        pool, restore them, and resume — only the unsalvageable sessions
        fail, each with a retriable `DriverRecovered`.

        Deliberately a *sync* method called from the driver coroutine: the
        gathered device fetch inside is the recovery path, not the hot
        loop, and the loop SHOULD stall here — there is no pool to serve
        until the rebuild finishes."""
        from repro_torch.serving import checkpoint as ckptlib
        t_rec = time.perf_counter()
        self.n_recoveries += 1
        old = self.pool
        if self.obs is not None and not isinstance(exc, InjectedFault):
            # injected faults were already folded by SessionPool._fire
            self.obs.fold_fault("driver")
        finished: List[RequestResult] = []
        failed: Dict[int, Exception] = {}
        # 1. resolve what the previous chunk already computed — those
        #    fetches were dispatched before the crash and are intact:
        try:
            finished.extend(old.flush())
        except Exception:
            pass    # the fetch itself was poisoned; those sessions fail
            #         below when their snapshots fail too
        # 2. snapshot the survivors: whole-pool first (one gathered
        #    fetch), per-session on failure so one poisoned slot doesn't
        #    take the rest down with it:
        snaps = []
        try:
            snaps = list(ckptlib.snapshot_pool(old).sessions)
        except Exception:
            for req_id in list(old._by_req):
                try:
                    snaps.append(ckptlib.snapshot_session(old, req_id))
                except Exception as sub:
                    failed[req_id] = sub
        # 3. fresh pool, same shape (max_frames tracks the old pool's
        #    grown bucket so restore never needs a regrow):
        kwargs = dict(self._pool_kwargs)
        kwargs["max_frames"] = old.pool_config()["max_frames"]
        new = SessionPool(self._engine, self.capacity, **kwargs)
        new.n_dispatches = old.n_dispatches          # stats continuity
        new._overlap_fracs = list(old._overlap_fracs)
        restored = []
        for snap in snaps:
            try:
                new.restore_session(snap)
                restored.append(snap)
            except Exception as sub:
                failed[snap.req_id] = sub
        self.pool = new
        # 4. restored streams with undelivered partial rows: mark them
        #    lagging so _service_lagging backfills [delivered_t, cursor)
        #    from the new pool's logits bank in one catch-up copy (a
        #    backfill staged in the old pool died with it):
        for snap in restored:
            cs = self._clients.get(snap.req_id)
            if cs is not None and cs.want_partials and not cs.lagging:
                cs.lagging, cs.backfill_hi = True, 0
                self._lagging.add(cs.req_id)
                try:
                    new.pause_partials(cs.req_id)
                except KeyError:
                    pass
        # 5. the unsalvageable fail individually — retriable, the server
        #    is alive again:
        for req_id, sub in failed.items():
            cs = self._clients.get(req_id)
            if cs is not None:
                self._settle_error(cs, DriverRecovered(
                    f"session {req_id} lost in driver recovery "
                    f"({type(exc).__name__}: {exc}); cause: {sub}"))
        if self.obs is not None:
            self.obs.fold_recovery(
                salvaged=len(restored), lost=len(failed),
                seconds=time.perf_counter() - t_rec)
        return finished, 0

    # -- observability -------------------------------------------------------

    def _fold_loop_side(self, *, dispatched: bool) -> None:
        """Fold the driver-loop-side signals the pool cannot see: lagging
        consumers, the deepest partial queue, connected streams.  When
        this iteration dispatched a chunk, also amend the boundary sample
        the pool just appended — host bookkeeping only, no device work."""
        obs = self.obs
        lagging = len(self._lagging)
        depth = max((cs.handle._partials.qsize()
                     for cs in self._clients.values()), default=0)
        obs.g_lagging.set(lagging)
        obs.g_queue_depth.set(depth)
        obs.g_connected.set(len(self._clients))
        if dispatched:
            obs.timeseries.update_last({
                "lagging": lagging,
                "partial_queue_depth_max": depth,
            })

    @property
    def n_connected(self) -> int:
        """Streams currently open (admitted + waiting)."""
        return len(self._clients)

    def stats(self) -> ServeStats:
        """Aggregate stats over the requests completed so far (same shape
        as `serve_requests`' — latency/TTFL/queue-wait percentiles are
        wall-clock, measured under whatever concurrency actually ran).
        Host reads only: the sparsity is the pool's staged copy, at most
        one chunk old while it runs."""
        t0 = self._t_start if self._t_start is not None else 0.0
        t1 = self._t_last if self._t_last is not None else t0
        return aggregate_stats(
            self._completed,
            capacity=self.capacity,
            n_requests=len(self._completed),
            total_steps=self._steps,
            wall_s=max(t1 - t0, 0.0),
            sparsity=self.pool.staged_sparsity(),
            chunk_frames=self.chunk_frames,
            n_dispatches=self.pool.n_dispatches,
            host_overlap_frac=self.pool.mean_host_overlap_frac(),
            bytes_per_slot=self.pool.bytes_per_slot(),
        )


def _bind_device(device: torch.device,
                 stream: Optional["torch.cuda.Stream"]) -> None:
    """Executor initializer: the tick worker launches on the device and
    the current stream of the thread that started the server."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.set_stream(stream)


def _as_frames(x: np.ndarray) -> np.ndarray:
    arr = np.asarray(x, np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"frames must be [n, D] or [D], got {arr.shape}")
    return arr


def _concat(blocks: List[np.ndarray]) -> Optional[np.ndarray]:
    if not blocks:
        return None
    return blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
