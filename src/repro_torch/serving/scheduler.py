"""Continuous-batching session scheduler for streaming DeltaLSTM serving —
port of the part of ``repro/serving/scheduler.py`` that
``serve_requests`` drives.

One weight-resident `BatchedSpartusEngine` and a `SessionPool` that
multiplexes complete utterances across its fixed-capacity slot dimension:

* `admit` attaches a request to a free slot; its frames are staged on the
  host and uploaded, with every other admission since the last dispatch,
  in one copy into the pool's ``[B, T_buf, D]`` device buffer.  The
  slot's state is re-initialised by the ``reset`` mask of the next step.
* `step` advances all active slots one frame (`step_frames`) and fetches
  the ``[B, n_classes]`` logits once per tick.
* `step_chunk` (``chunk_frames >= 1``) advances every slot up to C frames
  and banks the logits in a per-slot device output buffer; a finished
  session's rows are detached device-side when it retires and fetched to
  the host at the next boundary.

Not ported yet (see ROADMAP.md): incremental streams (``admit_stream`` /
``append_frames`` / ``finish_stream``), ``cancel``, partial-logit
streaming, the non-blocking ``tick``, observability, fault injection,
slot sharding, checkpoints and the cross-thread state lock that the
async front-end needs.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.serving import telemetry as tele
from repro_torch.serving.batched_engine import BatchedSpartusEngine, PoolState
from repro_torch.serving.engine import tensor_nbytes

#: default ceiling on the per-slot frame-buffer length (frames)
DEFAULT_MAX_BUFFER_FRAMES = 4096


def validated_frames(feats, req_id: int,
                     input_dim: Optional[int] = None) -> np.ndarray:
    """Admission-time payload validation: reject non-numeric dtypes and
    NaN/Inf values before they reach the shared device batch.  Returns
    the float32 frame array."""
    arr = np.asarray(feats)
    if arr.dtype.kind not in "fiu":
        raise ValueError(
            f"request {req_id}: frames have unsupported dtype {arr.dtype} "
            f"(expected a float or integer array)")
    arr = np.asarray(arr, np.float32)
    if input_dim is not None and arr.size and arr.shape[-1] != input_dim:
        raise ValueError(
            f"request {req_id}: feature dim {arr.shape[-1]} != "
            f"engine input dim {input_dim}")
    if not np.isfinite(arr).all():
        raise ValueError(f"request {req_id}: frames contain NaN/Inf values")
    return arr


@dataclasses.dataclass
class StreamRequest:
    """One streaming utterance: `feats [T, D]` arriving at `arrival_step`."""

    req_id: int
    arrival_step: int
    feats: np.ndarray

    @property
    def n_frames(self) -> int:
        return int(self.feats.shape[0])


@dataclasses.dataclass
class RequestResult:
    req_id: int
    arrival_step: int
    admit_step: int       # tick the request got a slot
    finish_step: int      # tick its last frame was produced
    logits: np.ndarray    # [T, n_classes]
    wall_latency_s: float  # wall time from eligibility to last frame
    truncated: bool = False  # stopped by max_steps with frames pending
    queue_wait_s: float = 0.0  # wall time from eligibility to admission
    ttfl_s: float = 0.0        # time to first logit (host-side)

    @property
    def queue_steps(self) -> int:
        return self.admit_step - self.arrival_step

    @property
    def service_steps(self) -> int:
        return self.finish_step - self.admit_step + 1

    @property
    def turnaround_steps(self) -> int:
        return self.finish_step - self.arrival_step + 1


@dataclasses.dataclass
class _Session:
    req_id: int
    arrival_step: int
    admit_step: int
    arrival_wall: float
    admit_wall: float
    total: int             # utterance length
    cursor: int = 0        # frames consumed by the engine
    last_step: int = 0     # tick of the most recent consumed frame
    needs_reset: bool = True
    first_logit_wall: float = 0.0  # 0.0 = no logits surfaced yet
    rows: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.cursor >= self.total

    @property
    def available(self) -> int:
        return self.total - self.cursor

    def result(self, logits: np.ndarray, *, truncated: bool = False,
               finish_step: Optional[int] = None) -> RequestResult:
        t_done = time.perf_counter()
        first = self.first_logit_wall if self.first_logit_wall else t_done
        return RequestResult(
            req_id=self.req_id,
            arrival_step=self.arrival_step,
            admit_step=self.admit_step,
            finish_step=self.last_step if finish_step is None else finish_step,
            logits=logits,
            wall_latency_s=t_done - self.arrival_wall,
            truncated=truncated,
            queue_wait_s=self.admit_wall - self.arrival_wall,
            ttfl_s=first - self.arrival_wall,
        )


@dataclasses.dataclass
class _PendingChunk:
    """Sessions that finished inside a dispatched chunk: their rows were
    snapshotted device-side and are fetched at the next boundary."""

    sessions: List[_Session]
    slots: List[int]
    rows: torch.Tensor     # [B, T_pad, n_classes] device-side snapshot


@dataclasses.dataclass
class ServeStats:
    capacity: int
    n_requests: int
    total_frames: int
    total_steps: int      # ticks that advanced >= 1 slot
    wall_s: float
    frames_per_s: float
    p50_latency_s: float
    p95_latency_s: float
    p50_turnaround_steps: float
    p95_turnaround_steps: float
    sparsity: Dict[str, float] = dataclasses.field(default_factory=dict)
    truncated: bool = False
    chunk_frames: int = 0            # 0 = per-frame path
    n_dispatches: int = 0
    dispatches_per_frame: float = 0.0
    # mean fraction of each chunk call's wall time the host spent after
    # the dispatch returned (0.0 on the per-frame path)
    host_overlap_frac: float = 0.0
    p99_latency_s: float = 0.0
    p50_queue_wait_s: float = 0.0
    p95_queue_wait_s: float = 0.0
    p99_queue_wait_s: float = 0.0
    p50_ttfl_s: float = 0.0
    p95_ttfl_s: float = 0.0
    p99_ttfl_s: float = 0.0
    bytes_per_slot: float = 0.0      # SessionPool.bytes_per_slot

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def aggregate_stats(
    results: Sequence[RequestResult], *, capacity: int, n_requests: int,
    total_steps: int, wall_s: float, sparsity: Dict[str, float],
    truncated: bool = False, chunk_frames: int = 0, n_dispatches: int = 0,
    host_overlap_frac: float = 0.0, bytes_per_slot: float = 0.0,
) -> ServeStats:
    """Reduce per-request results to the aggregate `ServeStats`."""
    frames = int(sum(r.logits.shape[0] for r in results))
    tas = np.array([r.turnaround_steps for r in results], np.float64)
    pl = tele.percentile_summary([r.wall_latency_s for r in results],
                                 "latency_s")
    pq = tele.percentile_summary([r.queue_wait_s for r in results],
                                 "queue_wait_s")
    pt = tele.percentile_summary([r.ttfl_s for r in results], "ttfl_s")
    return ServeStats(
        capacity=capacity,
        n_requests=n_requests,
        total_frames=frames,
        total_steps=total_steps,
        wall_s=wall_s,
        frames_per_s=frames / wall_s if wall_s > 0 else float("inf"),
        p50_latency_s=pl["p50_latency_s"],
        p95_latency_s=pl["p95_latency_s"],
        p99_latency_s=pl["p99_latency_s"],
        p50_turnaround_steps=float(np.percentile(tas, 50)) if len(tas) else 0.0,
        p95_turnaround_steps=float(np.percentile(tas, 95)) if len(tas) else 0.0,
        sparsity=sparsity,
        truncated=truncated,
        chunk_frames=chunk_frames,
        n_dispatches=n_dispatches,
        dispatches_per_frame=n_dispatches / frames if frames else 0.0,
        host_overlap_frac=host_overlap_frac,
        p50_queue_wait_s=pq["p50_queue_wait_s"],
        p95_queue_wait_s=pq["p95_queue_wait_s"],
        p99_queue_wait_s=pq["p99_queue_wait_s"],
        p50_ttfl_s=pt["p50_ttfl_s"],
        p95_ttfl_s=pt["p95_ttfl_s"],
        p99_ttfl_s=pt["p99_ttfl_s"],
        bytes_per_slot=bytes_per_slot,
    )


def _frame_bucket(n: int, floor: int = 64) -> int:
    """Frame-buffer length bucket: next power of two, >= ``floor``."""
    b = floor
    while b < n:
        b *= 2
    return b


class SessionPool:
    """Fixed-capacity pool of device-resident streaming sessions.

    With ``chunk_frames=C >= 1`` the pool runs the chunked tick loop
    (`step_chunk` / `flush`); otherwise the per-frame loop (`step`).  An
    utterance longer than ``max_buffer_frames`` is rejected at admission;
    the device frame buffers grow in pow2 buckets up to that ceiling.
    """

    def __init__(self, engine: BatchedSpartusEngine, capacity: int,
                 max_frames: int = 64, chunk_frames: int = 0,
                 max_buffer_frames: Optional[int] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if chunk_frames < 0:
            raise ValueError("chunk_frames must be >= 0 (0 = per-frame)")
        self.engine = engine
        self.capacity = capacity
        self.chunk_frames = chunk_frames
        self.max_buffer_frames = (DEFAULT_MAX_BUFFER_FRAMES
                                  if max_buffer_frames is None
                                  else int(max_buffer_frames))
        if max_frames > self.max_buffer_frames:
            raise ValueError(
                f"max_frames={max_frames} exceeds max_buffer_frames="
                f"{self.max_buffer_frames}")
        dev = engine.device
        self.state: PoolState = engine.init_state(capacity)
        self._slots: List[Optional[_Session]] = [None] * capacity
        self._by_req: Dict[int, int] = {}
        self._t_buf = _frame_bucket(max_frames)
        self._frames = torch.zeros((capacity, self._t_buf, engine.input_dim),
                                   dtype=torch.float32, device=dev)
        self._lengths = torch.zeros((capacity,), dtype=torch.int32,
                                    device=dev)
        # chunked mode: the logits bank, its time axis padded by
        # chunk_frames so a chunk's rows never run off the end
        self._out: Optional[torch.Tensor] = (
            engine.init_out_buf(capacity, self._t_buf + chunk_frames)
            if chunk_frames else None)
        self._pending: List[_PendingChunk] = []
        self._staged: List[Tuple[int, np.ndarray]] = []
        self.n_frame_grows = 0
        self.n_dispatches = 0
        self._overlap_fracs: List[float] = []

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_free(self) -> int:
        return self.capacity - self.n_active

    @property
    def has_pending(self) -> bool:
        """Chunked mode: retired sessions whose host fetch is outstanding."""
        return bool(self._pending)

    # -- admission -----------------------------------------------------------

    def admit(self, request: StreamRequest, now: int,
              arrival_wall: Optional[float] = None) -> bool:
        """Attach `request` to the first free slot; False if the pool is
        full.  Raises ValueError for an empty, malformed or oversized
        utterance."""
        if request.n_frames == 0:
            raise ValueError(f"request {request.req_id} has no frames")
        feats = validated_frames(request.feats, request.req_id,
                                 self.engine.input_dim)
        if request.req_id in self._by_req:
            raise ValueError(f"request {request.req_id} is already in the "
                             f"pool")
        n = int(feats.shape[0])
        if n > self.max_buffer_frames:
            raise ValueError(
                f"request {request.req_id}: utterance of {n} frames exceeds "
                f"the frame-buffer growth limit (max_buffer_frames="
                f"{self.max_buffer_frames}); split the stream or build the "
                f"pool with a larger limit")
        k = next((i for i, s in enumerate(self._slots) if s is None), None)
        if k is None:
            return False
        wall = time.perf_counter() if arrival_wall is None else arrival_wall
        self._slots[k] = _Session(
            req_id=request.req_id, arrival_step=request.arrival_step,
            admit_step=now, arrival_wall=wall,
            admit_wall=time.perf_counter(), total=n, last_step=now - 1)
        self._by_req[request.req_id] = k
        self._staged.append((k, feats))
        return True

    # -- device upload staging ----------------------------------------------

    def _grow_buffers(self, t_need: int) -> None:
        """One device-side realloc straight to ``t_need``'s pow2 bucket;
        resident frames are copied device to device."""
        old_t = self._t_buf
        new_t = _frame_bucket(t_need, floor=old_t)
        grown = self._frames.new_zeros((self.capacity, new_t,
                                        self.engine.input_dim))
        grown[:, :old_t] = self._frames
        self._frames = grown
        if self._out is not None:
            out = self._out.new_zeros((self.capacity, new_t + self.chunk_frames,
                                       self.engine.n_classes))
            out[:, :old_t + self.chunk_frames] = self._out
            self._out = out
        self._t_buf = new_t
        self.n_frame_grows += 1

    def _flush_uploads(self) -> None:
        """One host-to-device copy of every utterance admitted since the
        last dispatch (zero tails clear the slots' previous occupants)."""
        if not self._staged:
            return
        t_need = max(f.shape[0] for _, f in self._staged)
        if t_need > self._t_buf:
            self._grow_buffers(t_need)
        r = len(self._staged)
        rows = np.zeros((r, self._t_buf, self.engine.input_dim), np.float32)
        slots = np.zeros((r,), np.int64)
        ts = np.zeros((r,), np.int32)
        for i, (k, feats) in enumerate(self._staged):
            rows[i, :feats.shape[0]] = feats
            slots[i] = k
            ts[i] = feats.shape[0]
        self._staged.clear()
        dev = self.engine.device
        slot_t = torch.from_numpy(slots).to(dev)
        self._frames[slot_t] = torch.from_numpy(rows).to(dev)
        self._lengths[slot_t] = torch.from_numpy(ts).to(dev)

    def _masks(self) -> Tuple[np.ndarray, np.ndarray]:
        """active = occupied with unconsumed frames; reset = admitted since
        the last dispatch."""
        active = np.zeros((self.capacity,), bool)
        reset = np.zeros((self.capacity,), bool)
        for k, sess in enumerate(self._slots):
            if sess is None:
                continue
            active[k] = sess.available > 0
            reset[k] = sess.needs_reset
        return active, reset

    def _free(self, k: int) -> None:
        sess = self._slots[k]
        if sess is not None:
            del self._by_req[sess.req_id]
        self._slots[k] = None

    # -- per-frame tick loop -------------------------------------------------

    def step(self, now: int) -> List[RequestResult]:
        """Advance every active session one frame.  Returns the requests
        that finished on this tick."""
        if self.chunk_frames:
            raise RuntimeError(
                "this pool was built with chunk_frames >= 1; "
                "drive it with step_chunk()/flush(), not step()")
        active, reset = self._masks()
        if not active.any():
            return []
        self._flush_uploads()
        self.state, logits = self.engine.step_frames(
            self.state, self._frames, active, reset)
        self.n_dispatches += 1
        logits_np = logits.cpu().numpy()        # one device->host fetch/tick
        finished: List[RequestResult] = []
        for k, sess in enumerate(self._slots):
            if sess is None:
                continue
            sess.needs_reset = False
            if not active[k]:
                continue
            sess.rows.append(logits_np[k].copy())
            if not sess.first_logit_wall:
                sess.first_logit_wall = time.perf_counter()
            sess.cursor += 1
            sess.last_step = now
            if sess.done:
                finished.append(sess.result(np.stack(sess.rows)))
                self._free(k)
        return finished

    # -- chunked tick loop ---------------------------------------------------

    def max_chunk_advance(self) -> int:
        """Ticks the next ``step_chunk`` will consume (0 when idle)."""
        rem = [s.available for s in self._slots if s is not None]
        return min(self.chunk_frames, max(rem)) if rem else 0

    def _chunk_len(self) -> int:
        """Loop length of the next chunk: the pow2 bucket of the actual
        advance, capped at chunk_frames (the reference's compile bucket,
        kept so both packages step the same frames per dispatch)."""
        return min(self.chunk_frames,
                   _frame_bucket(self.max_chunk_advance(), floor=1))

    def step_chunk(self, now: int) -> List[RequestResult]:
        """Advance every active session up to ``chunk_frames`` frames.

        Returns the results of sessions that retired in the PREVIOUS
        chunk; sessions finishing in this one have their rows snapshotted
        device-side now and surface at the next ``step_chunk``/``flush``."""
        if not self.chunk_frames:
            raise RuntimeError(
                "this pool was built with chunk_frames=0; use step()")
        active, reset = self._masks()
        if not active.any():
            return self.flush()
        n = self._chunk_len()
        self._flush_uploads()
        t0 = time.perf_counter()
        self.state, self._out = self.engine.step_chunk(
            self.state, self._frames, self._lengths, active, reset,
            self._out, n_frames=n)
        self.n_dispatches += 1
        t_dispatched = time.perf_counter()
        retiring: List[_Session] = []
        slots: List[int] = []
        for k, sess in enumerate(self._slots):
            if sess is None:
                continue
            sess.needs_reset = False
            adv = min(n, sess.available)
            if adv <= 0:
                continue
            sess.cursor += adv
            sess.last_step = now + adv - 1
            if sess.done:
                retiring.append(sess)
                slots.append(k)
                self._free(k)
        newly = ([_PendingChunk(sessions=retiring, slots=slots,
                                rows=self.engine.snapshot_out(self._out))]
                 if retiring else [])
        finished = self._resolve()          # the PREVIOUS chunk's retirees
        t_end = time.perf_counter()
        self._pending.extend(newly)
        if t_end > t0:
            self._overlap_fracs.append((t_end - t_dispatched) / (t_end - t0))
        return finished

    def flush(self) -> List[RequestResult]:
        """Resolve retirements still pending from the last chunk."""
        return self._resolve()

    def _resolve(self) -> List[RequestResult]:
        pend, self._pending = self._pending, []
        out: List[RequestResult] = []
        for p in pend:
            rows = p.rows.cpu().numpy()         # one fetch for all retirees
            for sess, k in zip(p.sessions, p.slots):
                out.append(sess.result(rows[k, :sess.cursor].copy()))
        return out

    def mean_host_overlap_frac(self) -> float:
        return (float(np.mean(self._overlap_fracs)) if self._overlap_fracs
                else 0.0)

    def drain(self, now: int) -> List[RequestResult]:
        """Evict every in-flight session into truncated ``RequestResult``s
        holding the logits produced so far (``serve_requests`` hitting
        ``max_steps``)."""
        n_classes = self.engine.n_classes
        self._staged.clear()    # evicted sessions' uploads must not land
        out = self._resolve()
        for k, sess in enumerate(self._slots):
            if sess is None:
                continue
            if not sess.cursor:
                logits = np.zeros((0, n_classes), np.float32)
            elif self.chunk_frames:
                logits = self._out[k, :sess.cursor].cpu().numpy()
            else:
                logits = np.stack(sess.rows)
            out.append(sess.result(logits, truncated=not sess.done,
                                   finish_step=now))
            self._free(k)
        return out

    def measured_sparsity(self) -> Dict[str, float]:
        return self.engine.measured_sparsity(self.state)

    def bytes_per_slot(self) -> float:
        """Device bytes held per resident session: its share of the state
        slabs, frame buffer, logits bank and the shared packed weights."""
        total = sum(tensor_nbytes(t) for t in self.state.tensors())
        total += tensor_nbytes(self._frames) + tensor_nbytes(self._lengths)
        if self._out is not None:
            total += tensor_nbytes(self._out)
        total += self.engine.weight_bytes()
        return float(total / self.capacity)


RequestLike = Union[StreamRequest, Tuple[int, np.ndarray]]


def _normalize(requests: Iterable[RequestLike]) -> List[StreamRequest]:
    out: List[StreamRequest] = []
    for i, r in enumerate(requests):
        if isinstance(r, StreamRequest):
            out.append(r)
        else:
            arrival, feats = r
            out.append(StreamRequest(req_id=i, arrival_step=int(arrival),
                                     feats=np.asarray(feats, np.float32)))
    return sorted(out, key=lambda r: (r.arrival_step, r.req_id))


def serve_requests(
    engine: BatchedSpartusEngine,
    requests: Iterable[RequestLike],
    capacity: int,
    max_steps: Optional[int] = None,
    chunk_frames: int = 0,
) -> Tuple[List[RequestResult], ServeStats]:
    """Drive a request stream through a `SessionPool` to completion, on
    the engine's device.

    requests: StreamRequests or ``(arrival_step, feats [T, D])`` pairs.
    Admission is FIFO in arrival order; a request that finds the pool full
    waits.  ``chunk_frames=C >= 1`` selects the chunked tick loop, 0 the
    per-frame loop.  If ``max_steps`` stops the run early, in-flight
    sessions are drained into ``truncated`` results.  Returns per-request
    results sorted by ``req_id`` and aggregate stats."""
    pending = deque(_normalize(requests))
    n_requests = len(pending)
    max_frames = max((r.n_frames for r in pending), default=1)
    pool = SessionPool(
        engine, capacity, max_frames=max_frames, chunk_frames=chunk_frames,
        max_buffer_frames=max(max_frames, DEFAULT_MAX_BUFFER_FRAMES))
    waiting: deque = deque()
    results: List[RequestResult] = []
    now = 0
    total_steps = 0
    truncated = False
    t0 = time.perf_counter()

    while pending or waiting or pool.n_active or pool.has_pending:
        if not waiting and not pool.n_active and pending:
            now = max(now, pending[0].arrival_step)   # fast-forward idle time
        while pending and pending[0].arrival_step <= now:
            waiting.append((pending.popleft(), time.perf_counter()))
        while waiting and pool.n_free:
            req, arr_wall = waiting.popleft()
            pool.admit(req, now, arrival_wall=arr_wall)
        if chunk_frames:
            adv = pool.max_chunk_advance()
            results.extend(pool.step_chunk(now) if adv else pool.flush())
            total_steps += adv
            now += max(adv, 1)
        else:
            dispatched = pool.n_active > 0
            results.extend(pool.step(now))
            if dispatched:
                total_steps += 1
            now += 1
        if max_steps is not None and total_steps >= max_steps:
            truncated = bool(pending or waiting or pool.n_active)
            results.extend(pool.drain(now - 1))
            break

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    results.sort(key=lambda r: r.req_id)
    stats = aggregate_stats(
        results, capacity=capacity, n_requests=n_requests,
        total_steps=total_steps, wall_s=wall,
        sparsity=pool.measured_sparsity(), truncated=truncated,
        chunk_frames=chunk_frames, n_dispatches=pool.n_dispatches,
        host_overlap_frac=pool.mean_host_overlap_frac(),
        bytes_per_slot=pool.bytes_per_slot())
    return results, stats
