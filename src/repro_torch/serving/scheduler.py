"""Continuous-batching session scheduler for streaming DeltaLSTM serving —
port of ``repro/serving/scheduler.py``.

One weight-resident `BatchedSpartusEngine` and a `SessionPool` that
multiplexes streaming requests across its fixed-capacity slot dimension:

* `admit` attaches a complete utterance to a free slot; `admit_stream`
  admits a session whose utterance is still arriving: `append_frames`
  stages more frames, `finish_stream` closes the utterance and `cancel`
  abandons it.  Admissions and appends are staged on the host and
  written, one wave per dispatch boundary, into the pool's
  ``[B, T_buf, D]`` device frame buffer by one ``index_copy_`` at exact
  (slot, frame) offsets.  A session that has consumed everything it
  received rides the next chunk masked out, like a free slot.
* `step` advances all active slots one frame (`step_frames`) and fetches
  the ``[B, n_classes]`` logits once per tick.
* `step_chunk` (``chunk_frames >= 1``) advances every slot up to C frames
  and banks the logits in a per-slot device output buffer.  The pool is
  double-buffered: a session that retires inside a chunk has its rows
  copied into pinned host memory right behind that chunk, with a CUDA
  event (`engine.snapshot_out`), and its result is resolved at the next
  boundary by waiting on that event only — so the fetch overlaps the
  chunk dispatched in between instead of waiting for it.
  ``stream_partials=True`` does the same for each chunk's rows of every
  live slot (`engine.snapshot_chunk`), surfaced as `PartialLogits`.
* `tick` is the non-blocking driver entry point: at most one dispatch,
  dispatch-free retirements, and the double-buffer tail; it returns
  ``(finished_results, frames_advanced)``.  Host vectors reach the card
  through pinned, non-blocking copies, and the telemetry accumulators
  are staged to the host behind each chunk like its rows, so the only
  host wait is on the previous chunk's copy events.

`serve_requests` is the synchronous driver and the parity oracle of the
asyncio front-end (`serving/async_server.py`).

The pool's device state is updated in place (the reference donates it),
but `_grow_buffers` rebinds ``_frames`` and ``_out``, and a checkpoint
or an admin scrape on another thread must see a consistent pool: every
rebinding and every cross-thread read holds ``_state_lock`` (the
``_guarded_by_`` table below, linted by the reference's
``analysis/concurrency.py``).  A dispatch takes the lock only to read
and to rebind the tensors, not across its launches, so a reader never
waits for the host side of a chunk.

``n_devices=N`` shards the slot dimension (`serving/sharding.py`): the
pool holds one `_Shard` per contiguous block of slots, its slabs on its
own device and its chunk dispatched there by the engine's replica on
that device, with no shard waiting on another's chunk.  Admission picks
the least-loaded shard.  The devices may be one card N times
(``launch.mesh.emulated_devices``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import HostCopy, upload
from repro_torch.analysis import lockorder
from repro_torch.kernels import counters as kcount
from repro_torch.serving import sharding as shardlib
from repro_torch.serving import telemetry as tele
from repro_torch.serving.batched_engine import BatchedSpartusEngine, PoolState
from repro_torch.serving.engine import tensor_nbytes
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import NULL_TRACER, PoolObservability

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
class PartialLogits:
    """One streamed block of logits for a live session (``stream_partials``):
    rows ``[n, n_classes]`` covering frames ``[t0, t0 + n)``."""

    req_id: int
    t0: int
    rows: np.ndarray


@dataclasses.dataclass
class _Session:
    req_id: int
    arrival_step: int
    admit_step: int
    arrival_wall: float
    admit_wall: float
    total: Optional[int]   # utterance length; None while the client streams
    n_recv: int = 0        # frames received (staged for device upload)
    cursor: int = 0        # frames consumed by the engine
    last_step: int = 0     # tick of the most recent consumed frame
    needs_reset: bool = True
    cancelled: bool = False
    partials_paused: bool = False  # slow consumer: no per-chunk snapshots
    first_logit_wall: float = 0.0  # 0.0 = no logits surfaced yet
    rows: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        """Every frame of a finished utterance has been consumed."""
        return self.total is not None and self.cursor >= self.total

    @property
    def available(self) -> int:
        """Frames received but not yet consumed."""
        return self.n_recv - self.cursor

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
class _Shard:
    """One contiguous block of pool slots ``[lo, hi)`` and its device
    slabs; ``engine`` is the engine's replica on the shard's device.
    Slot ``k`` of the pool is row ``k - lo`` of every slab."""

    lo: int
    hi: int
    engine: BatchedSpartusEngine
    state: PoolState
    frames: torch.Tensor           # [hi - lo, T_buf, D]
    lengths: torch.Tensor          # [hi - lo]
    out: Optional[torch.Tensor]    # [hi - lo, T_buf + C, n_classes]


@dataclasses.dataclass
class _PendingChunk:
    """Sessions of one shard that finished inside a dispatched chunk:
    their rows were staged to pinned host memory behind that chunk and
    are resolved at the next boundary (row i of ``rows`` is
    ``sessions[i]``'s)."""

    sessions: List[_Session]
    rows: HostCopy         # [len(sessions), T, n_classes] once waited on


@dataclasses.dataclass
class _PendingPartials:
    """One shard's per-slot logits rows of one chunk
    (``engine.snapshot_chunk``), staged behind the chunk and resolved one
    boundary later."""

    entries: List[Tuple[_Session, int, int, int]]  # (session, row, t0, n)
    rows: HostCopy                                 # [rows, C, n_classes]


class _SummedCopies:
    """What the observability fold reads of one `HostCopy`: ``wait()``,
    the host sum of its first ``n_totals`` tensors (the shards'
    telemetry totals), and ``kernel_counts()``, the sum of the rest (the
    engines' ``[L, 6]`` launch counters, layer l's product
    ``kernels[l]``; None when nothing counts)."""

    def __init__(self, copy: HostCopy, n_totals: int,
                 kernels: Sequence[str] = ()):
        self.copy, self.n_totals, self.kernels = copy, n_totals, kernels

    def _parts(self) -> List[np.ndarray]:
        host = self.copy.wait()
        return [np.asarray(p) for p in
                ([host] if isinstance(host, torch.Tensor) else host)]

    def wait(self) -> np.ndarray:
        totals = self._parts()[:self.n_totals]
        return sum(p.astype(np.float64) for p in totals)

    def kernel_counts(self) -> Optional[np.ndarray]:
        counts = self._parts()[self.n_totals:]
        return sum(counts) if counts else None


def _host_list(copy: HostCopy) -> List[np.ndarray]:
    """A copy's host arrays as a list, however many it staged."""
    out = copy.numpy()
    return out if isinstance(out, list) else [out]


def _join_slots(parts: Sequence[np.ndarray], dim: int = 0) -> np.ndarray:
    """Host blocks of consecutive shards joined back along the slot dim."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=dim)


def _join_telemetry(host: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Host ``[nnz, ovf, steps]`` of every shard, in shard order -> the
    pool's three ``[L, capacity]`` accumulators."""
    return [_join_slots(host[i::3], dim=1) for i in range(3)]


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
    """Reduce per-request results to the aggregate `ServeStats` (shared by
    `serve_requests` and the asyncio front-end)."""
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
    (`step_chunk` / `flush` / `tick`); otherwise the per-frame loop
    (`step` / `tick`).  ``stream_partials=True`` also stages each chunk's
    rows so live sessions stream partial logits (`take_partials`).  An
    utterance longer than ``max_buffer_frames`` (declared at admission or
    reached by appends) is refused with a ValueError; the device frame
    buffers grow in pow2 buckets up to that ceiling.

    ``n_devices=N >= 1`` shards the slot dimension over a 1-D
    ``("data",)`` mesh of N devices of the engine's type
    (`serving/sharding.py`): every per-slot slab is split into contiguous
    blocks, one `_Shard` per device, each chunk dispatched per shard on
    its own device.  Admission places each session on the least-loaded
    shard; a capacity not divisible by N falls back to one shard
    (``n_shards == 1``), correct but not parallel.  ``None`` is one
    shard on the engine's device.  The API and the results are the
    same either way: only placement differs.
    """

    # Machine-checked lock discipline (repro_torch.analysis.concurrency,
    # and the reference's pass, which lints every .py under src/).  Each
    # shard's ``state`` is updated in place, but `_grow_buffers` rebinds
    # its ``frames`` and ``out``, a dispatch rebinds ``state`` and
    # ``out`` and a checkpoint restore writes ``state``; cross-thread
    # readers (the async server's ``stats()``, the admin endpoint,
    # snapshots) take the lock to read ``_shards``, and so do the staged
    # telemetry copy and its host values, which ``stats()`` reads.  Host
    # bookkeeping (``_slots``, ``_by_req``, ``_staged``,
    # ``_staged_appends``, ``_partials``) is tick/driver-thread-only and
    # deliberately absent; ``_bounds`` and ``_devices`` never change.
    _guarded_by_ = {
        "_shards": "_state_lock",
        "_pending": "_state_lock",
        "_pending_partials": "_state_lock",
        "_tele_copy": "_state_lock",
        "_tele_host": "_state_lock",
    }

    def __init__(self, engine: BatchedSpartusEngine, capacity: int,
                 max_frames: int = 64, chunk_frames: int = 0,
                 max_buffer_frames: Optional[int] = None,
                 stream_partials: bool = False,
                 n_devices: Optional[int] = None,
                 observability: Optional[PoolObservability] = None,
                 faults: Optional[FaultInjector] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if chunk_frames < 0:
            raise ValueError("chunk_frames must be >= 0 (0 = per-frame)")
        self.engine = engine
        self.capacity = capacity
        self.chunk_frames = chunk_frames
        self.stream_partials = stream_partials
        self.max_buffer_frames = (DEFAULT_MAX_BUFFER_FRAMES
                                  if max_buffer_frames is None
                                  else int(max_buffer_frames))
        if max_frames > self.max_buffer_frames:
            raise ValueError(
                f"max_frames={max_frames} exceeds max_buffer_frames="
                f"{self.max_buffer_frames}")
        self._n_devices = n_devices
        # seeded fault-injection hook (serving/faults.py); None = off
        self.faults = faults
        mesh = shardlib.make_pool_mesh(n_devices, engine.device)
        self._devices = shardlib.shard_devices(mesh, capacity)
        self.n_shards = len(self._devices)
        self._bounds = shardlib.shard_bounds(capacity, self.n_shards)
        self._slots: List[Optional[_Session]] = [None] * capacity
        self._by_req: Dict[int, int] = {}
        self._t_buf = _frame_bucket(max_frames)
        # every slab built whole on the first shard's device, then split
        # into the shards' blocks (the reference's one device_put)
        first = engine.on(self._devices[0])
        states = shardlib.shard_pool_state(first.init_state(capacity), mesh)
        frames = shardlib.shard_slot_array(torch.zeros(
            (capacity, self._t_buf, engine.input_dim), dtype=torch.float32,
            device=first.device), mesh)
        lengths = shardlib.shard_slot_array(torch.zeros(
            (capacity,), dtype=torch.int32, device=first.device), mesh)
        # chunked mode: the logits bank, its time axis padded by
        # chunk_frames so a chunk's rows never run off the end
        outs = (shardlib.shard_slot_array(first.init_out_buf(
            capacity, self._t_buf + chunk_frames), mesh)
            if chunk_frames else [None] * self.n_shards)
        self._shards = [
            _Shard(lo=lo, hi=hi, engine=engine.on(dev), state=st,
                   frames=fr, lengths=ln, out=out)
            for (lo, hi), dev, st, fr, ln, out in zip(
                self._bounds, self._devices, states, frames, lengths, outs)]
        self._pending: List[_PendingChunk] = []
        self._pending_partials: List[_PendingPartials] = []
        self._partials: List[PartialLogits] = []
        # the telemetry accumulators staged behind the last dispatch, and
        # the host values of the newest copy that has landed
        self._tele_copy: Optional[HostCopy] = None
        self._tele_host: Optional[List[np.ndarray]] = None
        # admissions (slot, feats) and appends (slot, start, feats),
        # staged on the host and written in one wave per boundary
        self._staged: List[Tuple[int, np.ndarray]] = []
        self._staged_appends: List[Tuple[int, int, np.ndarray]] = []
        self.n_frame_grows = 0
        self.n_dispatches = 0
        # host_overlap_frac of every chunk, as a running sum and count
        self._overlap_sum = 0.0
        self._overlap_n = 0
        # live observability (metrics.PoolObservability): folded at
        # dispatch boundaries only, on host values; None = off
        self.obs = observability
        self._tracer = (observability.tracer if observability is not None
                        else NULL_TRACER)
        self._adm_since_fold = 0
        if observability is not None:
            for sh in self._shards:          # the launch counters, which
                sh.engine.count_kernels()    # count inside _counting()
        self._state_lock = lockorder.make_lock("SessionPool._state_lock")

    def _counting(self):
        """Where the dispatch runs: its engines count their launches when
        this pool has observability, and not otherwise."""
        return (kcount.counting() if self.obs is not None
                else contextlib.nullcontext())

    def _fire(self, site: str) -> None:
        """Fault-injection hook: raise if the plan scheduled a failure at
        this invocation of ``site``.  A ``"poison"`` payload first empties
        every device state tensor in place (``Tensor.set_()``), modelling
        a crash that lost the state, so per-slot salvage fails and the
        watchdog's lost-session path runs."""
        if self.faults is None:
            return
        try:
            self.faults.fire(site)
        except Exception as exc:
            if self.obs is not None:
                self.obs.fold_fault(site)
            if getattr(exc, "payload", None) == "poison":
                with self._state_lock:
                    for sh in self._shards:
                        for t in sh.state.tensors():
                            t.set_()
            raise

    def _shard_of(self, k: int) -> int:
        """The shard holding pool slot ``k``."""
        return k // (self.capacity // self.n_shards)

    def shard_loads(self) -> List[int]:
        """Occupied-slot count per shard (admission placement telemetry)."""
        return [sum(s is not None for s in self._slots[lo:hi])
                for lo, hi in self._bounds]

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_free(self) -> int:
        return self.capacity - self.n_active

    @property
    def has_pending(self) -> bool:
        """Chunked mode: retired sessions (or streamed chunks) whose host
        fetch is still outstanding."""
        with self._state_lock:
            return bool(self._pending or self._pending_partials
                        or self._partials)

    @property
    def has_retirable(self) -> bool:
        """Sessions that can retire (or be reaped) without another
        dispatch."""
        return any(s is not None and (s.done or s.cancelled)
                   for s in self._slots)

    # -- admission -----------------------------------------------------------

    def admit(self, request: StreamRequest, now: int,
              arrival_wall: Optional[float] = None) -> bool:
        """Attach `request` (a complete utterance) to the first free slot;
        False if the pool is full.  Raises ValueError for an empty,
        malformed or oversized utterance."""
        if request.n_frames == 0:
            raise ValueError(f"request {request.req_id} has no frames")
        feats = validated_frames(request.feats, request.req_id,
                                 self.engine.input_dim)
        return self._bind(request.req_id, request.arrival_step, now, feats,
                          total=request.n_frames, arrival_wall=arrival_wall)

    def admit_stream(self, req_id: int, now: int,
                     feats: Optional[np.ndarray] = None,
                     arrival_step: Optional[int] = None,
                     arrival_wall: Optional[float] = None) -> bool:
        """Admit a session whose utterance is still arriving; False if the
        pool is full.  ``feats`` optionally carries the frames received so
        far; more arrive via ``append_frames`` and ``finish_stream``
        closes the utterance."""
        feats = (np.zeros((0, self.engine.input_dim), np.float32)
                 if feats is None else validated_frames(feats, req_id))
        return self._bind(req_id, now if arrival_step is None else
                          arrival_step, now, feats, total=None,
                          arrival_wall=arrival_wall)

    def _bind(self, req_id: int, arrival_step: int, now: int,
              feats: np.ndarray, total: Optional[int],
              arrival_wall: Optional[float]) -> bool:
        if req_id in self._by_req:
            raise ValueError(f"request {req_id} is already in the pool")
        if feats.size and feats.shape[-1] != self.engine.input_dim:
            raise ValueError(
                f"request {req_id}: feature dim {feats.shape[-1]} != "
                f"engine input dim {self.engine.input_dim}")
        n = int(feats.shape[0])
        if max(n, total or 0) > self.max_buffer_frames:
            raise ValueError(
                f"request {req_id}: utterance of {max(n, total or 0)} frames "
                f"exceeds the frame-buffer growth limit "
                f"(max_buffer_frames={self.max_buffer_frames}); split the "
                f"stream or build the pool with a larger limit")
        k = self._pick_slot()
        if k is None:
            return False
        wall = time.perf_counter() if arrival_wall is None else arrival_wall
        self._slots[k] = _Session(
            req_id=req_id, arrival_step=arrival_step, admit_step=now,
            arrival_wall=wall, admit_wall=time.perf_counter(), total=total,
            n_recv=n, last_step=now - 1)
        self._by_req[req_id] = k
        # a zero-length staging still resets the slot's device length
        self._staged.append((k, feats))
        self._adm_since_fold += 1
        if self.obs is not None:
            self.obs.fold_admissions(1)
        return True

    def _pick_slot(self) -> Optional[int]:
        """The first free slot on the least-loaded shard (ties toward the
        lower shard index), so admissions spread evenly across shards;
        with one shard, the first free slot."""
        best_k, best_load = None, self.capacity + 1
        for lo, hi in self._bounds:
            free = [k for k in range(lo, hi) if self._slots[k] is None]
            load = hi - lo - len(free)
            if free and load < best_load:
                best_k, best_load = free[0], load
        return best_k

    def _live(self, req_id: int) -> _Session:
        if req_id not in self._by_req:
            raise KeyError(f"request {req_id} is not in the pool")
        sess = self._slots[self._by_req[req_id]]
        assert sess is not None
        return sess

    def append_frames(self, req_id: int, feats: np.ndarray) -> None:
        """Stage more frames for a live streaming session (written with
        the next boundary's wave)."""
        sess = self._live(req_id)
        if sess.total is not None:
            raise ValueError(f"request {req_id} is already finished")
        if sess.cancelled:
            raise ValueError(f"request {req_id} was cancelled")
        feats = validated_frames(feats, req_id)
        if feats.ndim != 2 or feats.shape[-1] != self.engine.input_dim:
            raise ValueError(
                f"request {req_id}: appended frames must be [n, "
                f"{self.engine.input_dim}], got {feats.shape}")
        if feats.shape[0] == 0:
            return
        new_total = sess.n_recv + int(feats.shape[0])
        if new_total > self.max_buffer_frames:
            raise ValueError(
                f"request {req_id}: appending {feats.shape[0]} frames would "
                f"reach {new_total} frames, past the frame-buffer growth "
                f"limit (max_buffer_frames={self.max_buffer_frames})")
        self._staged_appends.append(
            (self._by_req[req_id], sess.n_recv, feats))
        sess.n_recv = new_total

    def finish_stream(self, req_id: int) -> None:
        """No more frames: the session retires once it has consumed
        everything received (possibly without another dispatch)."""
        sess = self._live(req_id)
        if sess.total is None:
            sess.total = sess.n_recv

    def cancel(self, req_id: int) -> None:
        """Abandon a session: its slot frees at the next boundary and no
        result is produced — also inside the retirement window (finished
        in a dispatched chunk, host fetch outstanding), where the staged
        rows are dropped at resolve time.  Raises KeyError only for a
        request the pool has no trace of."""
        if req_id in self._by_req:
            sess = self._slots[self._by_req[req_id]]
            assert sess is not None
            if not sess.cancelled and self.obs is not None:
                self.obs.fold_cancelled(1)
            sess.cancelled = True
            return
        with self._state_lock:
            pending = list(self._pending)
        for p in pending:
            for sess in p.sessions:
                if sess.req_id == req_id:
                    if not sess.cancelled and self.obs is not None:
                        self.obs.fold_cancelled(1)
                    sess.cancelled = True
                    return
        raise KeyError(f"request {req_id} is not in the pool")

    def pause_partials(self, req_id: int) -> None:
        """Stop staging partial-logit chunks for one live session (a
        lagging consumer); its rows keep banking on the device and stay
        recoverable with ``peek_rows``.  Chunked pools only."""
        if not self.chunk_frames:
            raise RuntimeError("pause_partials requires a chunked pool "
                               "(chunk_frames >= 1)")
        self._live(req_id).partials_paused = True

    def resume_partials(self, req_id: int) -> None:
        """Re-enable per-chunk partial snapshots for a live session."""
        if not self.chunk_frames:
            raise RuntimeError("resume_partials requires a chunked pool "
                               "(chunk_frames >= 1)")
        self._live(req_id).partials_paused = False

    def peek_rows(self, req_id: int, t0: int = 0) -> np.ndarray:
        """A live session's banked logits rows ``[t0, cursor)`` (chunked
        mode only): the slow-consumer backfill.  The copy is enqueued
        behind the in-flight chunk, whose rows it includes, and waited on
        by its own event — a rare, caller-initiated wait."""
        if not self.chunk_frames:
            raise RuntimeError("peek_rows requires a chunked pool "
                               "(chunk_frames >= 1)")
        sess = self._live(req_id)
        hi = sess.cursor
        if t0 >= hi:
            return np.zeros((0, self.engine.n_classes), np.float32)
        k = self._by_req[req_id]
        with self._state_lock:
            sh = self._shards[self._shard_of(k)]
            fetch = HostCopy(sh.out[k - sh.lo, t0:hi])
        return fetch.numpy()

    def backfill_partials(self, req_id: int, t0: int) -> int:
        """The slow-consumer backfill without a wait: stage a live
        session's banked rows ``[t0, cursor)`` to the host behind the
        last dispatched chunk, as one pending partial block that the next
        boundary resolves (and `take_partials` then returns) ahead of the
        next chunk's blocks, and resume its per-chunk snapshots.  Returns
        the number of rows staged (chunked mode only)."""
        if not self.chunk_frames:
            raise RuntimeError("backfill_partials requires a chunked pool "
                               "(chunk_frames >= 1)")
        sess = self._live(req_id)
        n = sess.cursor - t0
        if n > 0:
            k = self._by_req[req_id]
            with self._state_lock:
                sh = self._shards[self._shard_of(k)]
                j = k - sh.lo
                self._pending_partials.append(_PendingPartials(
                    entries=[(sess, 0, t0, n)],
                    rows=HostCopy(sh.out[j:j + 1, t0:sess.cursor])))
        sess.partials_paused = False
        return max(n, 0)

    def _reap_cancelled(self) -> None:
        """Free cancelled sessions' slots and drop their staged uploads
        (called at every boundary, before masks are computed)."""
        dead = [k for k, s in enumerate(self._slots)
                if s is not None and s.cancelled]
        if not dead:
            return
        gone = set(dead)
        for k in dead:
            self._free(k)
        self._staged = [(k, f) for k, f in self._staged if k not in gone]
        self._staged_appends = [(k, st, f) for k, st, f in
                                self._staged_appends if k not in gone]

    # -- device upload staging ----------------------------------------------

    def _grow_buffers(self, t_need: int) -> None:
        """One device-side realloc of every shard's buffers straight to
        ``t_need``'s pow2 bucket; resident frames (and banked logits) are
        copied device to device, each on its shard's device (caller holds
        ``_state_lock``)."""
        old_t = self._t_buf
        new_t = _frame_bucket(t_need, floor=old_t)
        for sh in self._shards:
            grown = sh.frames.new_zeros((sh.hi - sh.lo, new_t,
                                         self.engine.input_dim))
            grown[:, :old_t] = sh.frames
            sh.frames = grown
            if sh.out is not None:
                out = sh.out.new_zeros((sh.hi - sh.lo,
                                        new_t + self.chunk_frames,
                                        self.engine.n_classes))
                out[:, :old_t + self.chunk_frames] = sh.out
                sh.out = out
        self._t_buf = new_t
        self.n_frame_grows += 1

    def _flush_uploads(self) -> None:
        """Write every admission and append staged since the last boundary
        into the device frame buffers: per shard with staged rows, one
        host-to-device copy of its new frames and their flat (row, frame)
        offsets, one ``index_copy_``, and its slots' new lengths.  An
        admission writes frames ``[0, n)`` of its slot; an append
        ``[start, start + n)``, where start is the frames received before
        it — positions are exact, so nothing clamps into earlier frames.
        Buffers too short for the wave grow first, straight to the bucket
        it needs."""
        self._fire("admission_upload")
        blocks = ([(k, 0, f) for k, f in self._staged]
                  + self._staged_appends)
        if not blocks:
            return
        lengths: Dict[int, int] = {}
        for k, start, feats in blocks:
            lengths[k] = start + int(feats.shape[0])
        t_need = max(lengths.values())
        with self._state_lock:
            if t_need > self._t_buf:
                self._grow_buffers(t_need)
            t_buf = self._t_buf
            for sh in self._shards:
                mine = [(k - sh.lo, start, f) for k, start, f in blocks
                        if sh.lo <= k < sh.hi and f.shape[0]]
                dev = sh.engine.device
                if mine:
                    flat = np.concatenate([
                        j * t_buf + start + np.arange(f.shape[0],
                                                      dtype=np.int64)
                        for j, start, f in mine])
                    rows = np.concatenate([f for _, _, f in mine])
                    sh.frames.view(-1, self.engine.input_dim).index_copy_(
                        0, upload(flat, dev), upload(rows, dev))
                ks = [k for k in lengths if sh.lo <= k < sh.hi]
                if ks:
                    slots = np.array(ks, np.int64) - sh.lo
                    ts = np.array([lengths[k] for k in ks], np.int32)
                    sh.lengths.index_copy_(0, upload(slots, dev),
                                           upload(ts, dev))
        self._staged.clear()
        self._staged_appends.clear()

    def _masks(self) -> Tuple[np.ndarray, np.ndarray]:
        """active = occupied with unconsumed frames (a starved stream
        rides along masked out); reset = admitted since the last
        dispatch."""
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
        with self._tracer.span("slot_bookkeeping"):
            self._reap_cancelled()
            active, reset = self._masks()
        if not active.any():
            return []
        with self._tracer.span("admission_upload"):
            self._flush_uploads()
        self._fire("dispatch")
        t0 = time.perf_counter()
        with self._state_lock:
            shards = [(sh.engine, sh.lo, sh.hi, sh.state, sh.frames)
                      for sh in self._shards]
        with self._tracer.span("dispatch"), self._counting():
            logits = [eng.step_frames(state, frames, active[lo:hi],
                                      reset[lo:hi])[1]
                      for eng, lo, hi, state, frames in shards]
        with self._tracer.span("partials_stage"), self._state_lock:
            self._tele_copy = self._stage_telemetry()
        self.n_dispatches += 1
        t_dispatched = time.perf_counter()
        with self._tracer.span("snapshot_fetch"):
            # one fetch per tick
            logits_np = _join_slots(_host_list(HostCopy(*logits)))
            self._resolve_telemetry()              # landed before logits
        finished: List[RequestResult] = []
        with self._tracer.span("slot_bookkeeping"):
            for k, sess in enumerate(self._slots):
                if sess is None:
                    continue
                sess.needs_reset = False
                if not active[k]:
                    continue
                row = logits_np[k].copy()
                sess.rows.append(row)
                if not sess.first_logit_wall:
                    sess.first_logit_wall = time.perf_counter()
                if self.stream_partials:
                    self._partials.append(PartialLogits(
                        req_id=sess.req_id, t0=sess.cursor, rows=row[None]))
                sess.cursor += 1
                sess.last_step = now
                if sess.done:
                    finished.append(sess.result(np.stack(sess.rows)))
                    self._free(k)
        if self.obs is not None:
            with self._tracer.span("obs_fold"):
                self.obs.fold_results(finished)
                self._fold_boundary(
                    n_active=int(active.sum()), frames=int(active.sum()),
                    dispatch_s=t_dispatched - t0,
                    chunk_s=time.perf_counter() - t0,
                    overlap=0.0, retirements=len(finished))
        return finished

    # -- chunked tick loop ---------------------------------------------------

    def max_chunk_advance(self) -> int:
        """Ticks the next ``step_chunk`` will consume (0 when every
        session is starved or none is active)."""
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
        chunk: their rows were staged to the host behind that chunk, and
        resolving them waits on that copy only — not on the chunk just
        dispatched.  Sessions finishing in this chunk surface at the next
        ``step_chunk``/``tick``/``flush``; with ``stream_partials`` every
        advancing session's rows surface as ``PartialLogits`` on the same
        one-chunk-later cadence."""
        if not self.chunk_frames:
            raise RuntimeError(
                "this pool was built with chunk_frames=0; use step()")
        with self._tracer.span("slot_bookkeeping"):
            self._reap_cancelled()
        self._queue_done_retirements()
        with self._tracer.span("slot_bookkeeping"):
            active, reset = self._masks()
            busy = active.any()
            if busy:
                n = self._chunk_len()
                starts = np.array([0 if s is None else s.cursor
                                   for s in self._slots], np.int32)
        if not busy:
            return self.flush()
        with self._tracer.span("admission_upload"):
            self._flush_uploads()
        self._fire("dispatch")
        t0 = time.perf_counter()
        with self._state_lock:
            shards = list(self._shards)
            args = [(sh.state, sh.frames, sh.lengths, active[sh.lo:sh.hi],
                     reset[sh.lo:sh.hi], sh.out) for sh in shards]
        with self._tracer.span("dispatch"), self._counting():
            states, outs = shardlib.dispatch_chunk(
                *zip(*args), engines=[sh.engine for sh in shards],
                n_frames=n)
        with self._tracer.span("partials_stage"), self._state_lock:
            for sh, state, out in zip(shards, states, outs):
                sh.state, sh.out = state, out
            tele_copy = self._stage_telemetry()
        self.n_dispatches += 1
        t_dispatched = time.perf_counter()

        # ---- everything below overlaps the in-flight device chunk ----
        retiring: List[int] = []
        partial_slots: List[int] = []
        frames_this = 0
        with self._tracer.span("slot_bookkeeping"):
            for k, sess in enumerate(self._slots):
                if sess is None:
                    continue
                sess.needs_reset = False
                adv = min(n, sess.available)
                if adv <= 0:
                    continue
                frames_this += adv
                sess.cursor += adv
                sess.last_step = now + adv - 1
                if self.stream_partials and not sess.partials_paused:
                    partial_slots.append(k)
                if sess.done:
                    retiring.append(k)
        newly: List[_PendingChunk] = []
        newly_partials: List[_PendingPartials] = []
        if retiring or partial_slots:
            with self._tracer.span("partials_stage"), self._state_lock:
                newly = self._snapshot_retirees(retiring)
                for sh in self._shards:
                    entries = [
                        (self._slots[k], k - sh.lo, int(starts[k]),
                         self._slots[k].cursor - int(starts[k]))
                        for k in partial_slots if sh.lo <= k < sh.hi]
                    if entries:
                        newly_partials.append(_PendingPartials(
                            entries=entries,
                            rows=sh.engine.snapshot_chunk(
                                sh.out, starts[sh.lo:sh.hi], n_frames=n)))
            with self._tracer.span("slot_bookkeeping"):
                for k in retiring:
                    self._free(k)
        with self._tracer.span("snapshot_fetch"):
            finished = self._resolve()       # the PREVIOUS chunk's copies
        t_end = time.perf_counter()
        with self._tracer.span("slot_bookkeeping"):
            with self._state_lock:
                self._pending.extend(newly)
                self._pending_partials.extend(newly_partials)
                self._tele_copy = tele_copy
            wall = t_end - t0
            overlap = 0.0
            if wall > 0:
                overlap = (t_end - t_dispatched) / wall
                self._overlap_sum += overlap
                self._overlap_n += 1
        if self.obs is not None:
            with self._tracer.span("obs_fold"):
                self._fold_boundary(
                    n_active=int(active.sum()), frames=frames_this,
                    dispatch_s=t_dispatched - t0, chunk_s=wall,
                    overlap=overlap, retirements=len(finished))
        return finished

    def _snapshot_retirees(self, slots: List[int]) -> List[_PendingChunk]:
        """Stage the retiring ``slots``' banked rows to the host behind the
        chunk that wrote them, one fetch per shard that holds any (caller
        holds ``_state_lock``; the slots are still bound)."""
        pend = []
        for sh in self._shards:
            mine = [k for k in slots if sh.lo <= k < sh.hi]
            if not mine:
                continue
            sessions = [self._slots[k] for k in mine]
            n_rows = max(1, max(s.cursor for s in sessions))
            pend.append(_PendingChunk(
                sessions=sessions,
                rows=sh.engine.snapshot_out(
                    sh.out, [k - sh.lo for k in mine], n_rows=n_rows)))
        return pend

    def _queue_done_retirements(self) -> None:
        """Retire sessions that are already done WITHOUT another dispatch
        (a stream finished after its last received frame was consumed, or
        with zero frames): stage their banked rows now; the results
        surface at the next resolve like any other retirement."""
        with self._tracer.span("slot_bookkeeping"):
            slots = [k for k, sess in enumerate(self._slots)
                     if sess is not None and sess.done]
        if slots:
            with self._tracer.span("partials_stage"), self._state_lock:
                self._pending.extend(self._snapshot_retirees(slots))
            with self._tracer.span("slot_bookkeeping"):
                for k in slots:
                    self._free(k)

    def flush(self) -> List[RequestResult]:
        """Resolve retirements (and streamed partials) still pending from
        the last dispatched chunk (the double-buffer tail)."""
        if self.chunk_frames:
            with self._tracer.span("slot_bookkeeping"):
                self._reap_cancelled()
            self._queue_done_retirements()
        return self._resolve()

    def tick(self, now: int) -> Tuple[List[RequestResult], int]:
        """Non-blocking driver entry: at most one dispatch, in either mode.

        Returns ``(finished_results, frames_advanced)``.  Safe to call
        with nothing to do; handles cancellations, dispatch-free
        retirements and the double-buffer tail.  The only host wait is
        on the previous chunk's staged copies (per-frame mode waits for
        its own logits, as always)."""
        if self.chunk_frames:
            with self._tracer.span("slot_bookkeeping"):
                adv = self.max_chunk_advance()
            if adv:
                return self.step_chunk(now), adv
            return self.flush(), 0
        with self._tracer.span("slot_bookkeeping"):
            self._reap_cancelled()
            finished: List[RequestResult] = []
            for k, sess in enumerate(self._slots):
                if sess is not None and sess.done:
                    finished.append(sess.result(
                        np.stack(sess.rows) if sess.rows else np.zeros(
                            (0, self.engine.n_classes), np.float32)))
                    self._free(k)
        if self.obs is not None:
            with self._tracer.span("obs_fold"):
                self.obs.fold_results(finished)
        with self._tracer.span("slot_bookkeeping"):
            active, _ = self._masks()
        if active.any():
            return finished + self.step(now), 1
        return finished, 0

    def take_partials(self) -> List[PartialLogits]:
        """Drain the streamed per-chunk logits resolved so far (in frame
        order per session; ``stream_partials`` only)."""
        out, self._partials = self._partials, []
        return out

    def _resolve(self) -> List[RequestResult]:
        self._resolve_telemetry()
        self._resolve_partials()
        return self._resolve_pending()

    def _stage_telemetry(self) -> HostCopy:
        """Every shard's telemetry accumulators, staged to the host behind
        the chunk just dispatched (caller holds ``_state_lock``)."""
        return HostCopy(*(t for sh in self._shards
                          for t in sh.state.telemetry))

    def _resolve_telemetry(self) -> None:
        """Wait for the telemetry copy staged behind the previous
        dispatch and keep its host values (what `staged_sparsity`
        reads)."""
        with self._state_lock:
            copy, self._tele_copy = self._tele_copy, None
        if copy is not None:
            host = copy.numpy()                # waits on its own events
            with self._state_lock:
                self._tele_host = host

    def _resolve_partials(self) -> None:
        with self._state_lock:
            pend, self._pending_partials = self._pending_partials, []
        for p in pend:
            rows = p.rows.numpy()              # waits on its own event
            for sess, k, t0, adv in p.entries:
                if sess.cancelled:
                    continue                   # cancelled mid-window
                if not sess.first_logit_wall:
                    sess.first_logit_wall = time.perf_counter()
                self._partials.append(PartialLogits(
                    req_id=sess.req_id, t0=t0, rows=rows[k, :adv].copy()))

    def _resolve_pending(self) -> List[RequestResult]:
        with self._state_lock:
            pend, self._pending = self._pending, []
        out: List[RequestResult] = []
        for p in pend:
            rows = p.rows.numpy()              # waits on its own event
            for i, sess in enumerate(p.sessions):
                if sess.cancelled:
                    continue   # cancelled inside the retirement window:
                    #            the staged rows are dropped, never delivered
                out.append(sess.result(rows[i, :sess.cursor].copy()))
        if self.obs is not None and out:
            self.obs.fold_results(out)
        return out

    def _fold_boundary(self, *, n_active: int, frames: int,
                       dispatch_s: float, chunk_s: float, overlap: float,
                       retirements: int) -> None:
        """One dispatch boundary's fold into the observability layer —
        host values only, plus the telemetry totals and the engines'
        launch counters, staged to the host in one copy behind this
        chunk, which the NEXT boundary's fold resolves."""
        adm, self._adm_since_fold = self._adm_since_fold, 0
        totals = self.telemetry_totals()
        counters = self._kernel_counters()
        totals = _SummedCopies(
            HostCopy(*totals, *(c.table for c in counters)), len(totals),
            counters[0].kernels if counters else ())
        self.obs.fold_chunk(
            occupancy=self.n_active,
            capacity=self.capacity,
            n_active=n_active,
            frames_advanced=frames,
            dispatch_s=dispatch_s,
            chunk_s=chunk_s,
            host_overlap_frac=overlap,
            admissions=adm,
            retirements=retirements,
            shard_loads=self.shard_loads(),
            telemetry_totals=totals,
        )

    def synchronize(self) -> None:
        """Wait for every shard's device to finish its queued work (a
        no-op on the host)."""
        for i, dev in enumerate(self._devices):
            if dev.type == "cuda" and dev not in self._devices[:i]:
                torch.cuda.synchronize(dev)

    def mean_host_overlap_frac(self) -> float:
        return (self._overlap_sum / self._overlap_n if self._overlap_n
                else 0.0)

    def drain(self, now: int) -> List[RequestResult]:
        """Evict every in-flight session into truncated ``RequestResult``s
        holding the logits produced so far (``serve_requests`` hitting
        ``max_steps``).  Pending retirements are resolved first."""
        n_classes = self.engine.n_classes
        self._staged.clear()    # evicted sessions' uploads must not land
        self._staged_appends.clear()
        self._reap_cancelled()
        out: List[RequestResult] = self._resolve()
        bank = None
        if self.chunk_frames and self.n_active:
            with self._state_lock:
                bank = HostCopy(*(sh.out for sh in self._shards))
            bank = _join_slots(_host_list(bank))
        drained: List[RequestResult] = []
        for k, sess in enumerate(self._slots):
            if sess is None:
                continue
            if bank is not None:
                logits = bank[k, :sess.cursor].copy()
            else:
                logits = (np.stack(sess.rows) if sess.rows
                          else np.zeros((0, n_classes), np.float32))
            drained.append(sess.result(logits, truncated=not sess.done,
                                       finish_step=now))
            self._free(k)
        if self.obs is not None:
            self.obs.fold_results(drained)
        return out + drained

    def measured_sparsity(self) -> Dict[str, float]:
        """The telemetry summed over every slot of every shard (one host
        fetch of each shard's accumulators)."""
        # the lock keeps a restore on another thread from writing the
        # state mid-fetch; the fetch itself follows the in-flight chunk
        with self._state_lock:
            host = [t.detach().cpu().numpy() for sh in self._shards
                    for t in sh.state.telemetry]
        return tele.summarize(*_join_telemetry(host),
                              self.engine.n_cols)

    def _kernel_counters(self) -> list:
        """The launch counters of the shards' engines, each once (shards
        on one device share their engine, and its counters)."""
        out = {}
        with self._state_lock:
            for sh in self._shards:
                if sh.engine.counters is not None:
                    out.setdefault(id(sh.engine.counters),
                                   sh.engine.counters)
        return list(out.values())

    def telemetry_totals(self) -> List[torch.Tensor]:
        """Each shard's ``[3]`` running totals, reduced on its device (no
        host sync); the pool's totals are their sum."""
        with self._state_lock:
            return [sh.engine.telemetry_totals(sh.state)
                    for sh in self._shards]

    def staged_sparsity(self) -> Dict[str, float]:
        """`measured_sparsity` as of the newest dispatch whose telemetry
        copy has landed (one chunk behind at most while the pool runs,
        exact once it is idle and flushed).  It never waits on the
        device: the read for a thread that must not (the async server's
        ``stats()``)."""
        with self._state_lock:
            copy = self._tele_copy
            landed = None if copy is None else copy.poll()
            if landed is not None:
                self._tele_copy = None
                self._tele_host = [t.numpy() for t in landed]
            host = self._tele_host
        if host is None:
            return tele.summarize(np.zeros(1), np.zeros(1), np.zeros(1), [1])
        return tele.summarize(*_join_telemetry(host),
                              self.engine.n_cols)

    def bytes_per_slot(self) -> float:
        """Device bytes held per resident session: its share of the state
        slabs, frame buffer, logits bank and the shared packed weights.
        Shape arithmetic only; folds the ``spartus_slot_bytes`` gauge when
        observability is attached.  The weights count once per device
        that holds a replica."""
        with self._state_lock:
            total = 0
            for sh in self._shards:
                total += sum(tensor_nbytes(t) for t in sh.state.tensors())
                total += (tensor_nbytes(sh.frames)
                          + tensor_nbytes(sh.lengths))
                if sh.out is not None:
                    total += tensor_nbytes(sh.out)
            replicas = {id(sh.engine): sh.engine for sh in self._shards}
        total += sum(e.weight_bytes() for e in replicas.values())
        per_slot = total / self.capacity
        if self.obs is not None:
            self.obs.fold_slot_bytes(per_slot)
        return float(per_slot)

    # -- checkpoint / restore (serving/checkpoint.py) ------------------------

    def pool_config(self) -> Dict[str, object]:
        """Constructor kwargs that rebuild an equivalent (empty) pool —
        the watchdog's recovery recipe; ``max_frames`` is the current
        buffer bucket, so the rebuilt pool needs no regrow."""
        return dict(
            capacity=self.capacity,
            max_frames=self._t_buf,
            chunk_frames=self.chunk_frames,
            max_buffer_frames=self.max_buffer_frames,
            stream_partials=self.stream_partials,
            n_devices=self._n_devices,
        )

    def snapshot(self):
        """In-memory whole-pool snapshot (``PoolCheckpoint``): every live
        session in one gathered device-to-host fetch.  Call ``flush()``
        first if the double-buffer tail must be resolved, not dropped."""
        from repro_torch.serving import checkpoint as ckptlib

        return ckptlib.snapshot_pool(self)

    def snapshot_session(self, req_id: int):
        """Serialize one live session (``SessionSnapshot``)."""
        from repro_torch.serving import checkpoint as ckptlib

        return ckptlib.snapshot_session(self, req_id)

    def restore_session(self, snap) -> bool:
        """Restore one ``SessionSnapshot`` into a free slot; False when
        the pool is full.  The session continues bit-identically."""
        from repro_torch.serving import checkpoint as ckptlib

        return ckptlib.restore_session(self, snap)

    def checkpoint(self, path: str) -> List[RequestResult]:
        """Write the whole pool to a checkpoint directory (atomic,
        committed, retained).  Flushes the double-buffer tail first and
        returns those finished results."""
        from repro_torch.serving import checkpoint as ckptlib

        return ckptlib.save_pool(self, path)

    def restore(self, path: str, step: Optional[int] = None) -> None:
        """Load a pool checkpoint into THIS (fresh, empty) pool; its
        capacity may differ from the writer's."""
        from repro_torch.serving import checkpoint as ckptlib

        ckptlib.restore_into(self, ckptlib.load_checkpoint(path, step))


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
    n_devices: Optional[int] = None,
    observability: Optional[PoolObservability] = None,
) -> Tuple[List[RequestResult], ServeStats]:
    """Drive a request stream through a `SessionPool` to completion, on
    the engine's device.

    requests: StreamRequests or ``(arrival_step, feats [T, D])`` pairs.
    Admission is FIFO in arrival order; a request that finds the pool full
    waits.  ``chunk_frames=C >= 1`` selects the chunked tick loop, 0 the
    per-frame loop.  If ``max_steps`` stops the run early, in-flight
    sessions are drained into ``truncated`` results.  ``n_devices=N``
    shards the pool's slot dimension over N devices
    (`SessionPool(n_devices=...)`): same API, same results.
    ``observability`` folds every dispatch boundary into a
    `PoolObservability`; results are the same with it on or off.  Returns
    per-request results sorted by ``req_id`` and aggregate stats."""
    pending = deque(_normalize(requests))
    n_requests = len(pending)
    max_frames = max((r.n_frames for r in pending), default=1)
    pool = SessionPool(
        engine, capacity, max_frames=max_frames, chunk_frames=chunk_frames,
        max_buffer_frames=max(max_frames, DEFAULT_MAX_BUFFER_FRAMES),
        n_devices=n_devices, observability=observability)
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

    pool.synchronize()
    wall = time.perf_counter() - t0
    if observability is not None:
        observability.flush_totals()
    results.sort(key=lambda r: r.req_id)
    stats = aggregate_stats(
        results, capacity=capacity, n_requests=n_requests,
        total_steps=total_steps, wall_s=wall,
        sparsity=pool.measured_sparsity(), truncated=truncated,
        chunk_frames=chunk_frames, n_dispatches=pool.n_dispatches,
        host_overlap_frac=pool.mean_host_overlap_frac(),
        bytes_per_slot=pool.bytes_per_slot())
    return results, stats
