"""Session checkpoint/restore for the serving pool — port of
``repro/serving/checkpoint.py``, the recovery and migration primitive of
the robustness layer.

A session, for checkpoint purposes, is the state the chunked tick loop
threads through `engine.step_chunk` plus the scheduler's host-side
bookkeeping for its slot:

  * per-layer recurrent rows — ``s_hat``, ``c``, ``h``, ``dm`` of each
    `BatchedLayerState`;
  * the slot's telemetry columns (sparsity accumulators);
  * the frames received so far (the device frame-buffer row, overlaid
    with any host-staged blocks not yet written);
  * the banked logits rows ``[0, cursor)`` (chunked mode) or the host row
    list (per-frame mode);
  * the `_Session` metadata.

Every slot is computationally independent, so a session restored into
any slot of any pool with the same engine continues bit-identically:
slot index, capacity and shard count are placement, not semantics.  A
checkpoint written at one shard count restores at another.

Fetch discipline: a snapshot takes ONE gathered device-to-host fetch
(`HostCopy` of every tensor it reads, one event per device) under the
pool's state lock, and joins the shards' blocks back over the pool's
slots (`serving/sharding.py`).  Restores write rows in place with
``index_copy_`` (the reference uses jitted, donating scatters), each
into its shard's tensors on its device.  File IO rides
`training/checkpoint.py`.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, TYPE_CHECKING

import numpy as np

import torch

from repro_torch._device import HostCopy, upload
from repro_torch.serving import sharding as shardlib
from repro_torch.serving.batched_engine import PoolState
from repro_torch.training.checkpoint import CheckpointManager

if TYPE_CHECKING:  # import cycle: the scheduler imports this lazily
    from repro_torch.serving.scheduler import RequestResult, SessionPool

FORMAT = "spartus-pool"
VERSION = 1

_LAYER_FIELDS = ("s_hat", "c", "h", "dm")


# -- snapshot containers ------------------------------------------------------


@dataclasses.dataclass
class SessionSnapshot:
    """One session's full state: JSON-able ``meta`` + named host arrays.

    Array keys: ``layer{i}/{s_hat,c,h,dm}``, ``telemetry`` ``[3, L]``
    (nnz_sum / overflow_steps / steps columns), ``frames`` ``[n_recv, D]``
    and ``rows`` ``[cursor, n_classes]`` (the banked logits)."""

    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]

    @property
    def req_id(self) -> int:
        return int(self.meta["req_id"])


@dataclasses.dataclass
class PoolCheckpoint:
    """A whole pool's live sessions plus the engine fingerprint that
    guards restore compatibility."""

    meta: Dict[str, Any]
    sessions: List[SessionSnapshot]


def engine_fingerprint(engine) -> Dict[str, Any]:
    """The engine identity a checkpoint is only valid against: layer
    shapes and the sparsity/quantization parameters that change the
    computed numbers.  The quantization entry keeps a quantized pool from
    restoring an fp32 pool's sessions (and vice versa): the recurrent
    state evolves on another numeric grid."""
    from repro_torch.serving.engine import active_quant

    quant = active_quant(engine.cfg)
    return {
        "input_dim": int(engine.input_dim),
        "n_classes": int(engine.n_classes),
        "layers": [[int(l.input_dim), int(l.hidden_dim)]
                   for l in engine.layers],
        "theta": float(engine.cfg.theta),
        "gamma": float(engine.cfg.gamma),
        "quant": (None if quant is None else
                  [int(quant.weight_bits), int(quant.act_bits),
                   int(quant.act_frac_bits)]),
    }


def _fp_key(fp: Dict[str, Any]) -> str:
    return json.dumps(fp, sort_keys=True)


def _check_engine(pool: "SessionPool", meta: Dict[str, Any]) -> None:
    have = engine_fingerprint(pool.engine)
    want = meta.get("engine")
    if want is None or _fp_key(have) != _fp_key(want):
        raise ValueError(
            f"checkpoint engine fingerprint {want} does not match the "
            f"pool's engine {have}; restore requires the same model "
            f"shapes and sparsity config (theta/gamma)")


# -- session snapshot ---------------------------------------------------------


def _session_meta(sess) -> Dict[str, Any]:
    return {
        "req_id": int(sess.req_id),
        "arrival_step": int(sess.arrival_step),
        "admit_step": int(sess.admit_step),
        "total": None if sess.total is None else int(sess.total),
        "n_recv": int(sess.n_recv),
        "cursor": int(sess.cursor),
        "last_step": int(sess.last_step),
        "needs_reset": bool(sess.needs_reset),
        "partials_paused": bool(sess.partials_paused),
        "had_first_logit": bool(sess.first_logit_wall),
    }


def _overlay_frames(pool: "SessionPool", sess, k: int,
                    dev_row: Optional[np.ndarray]) -> np.ndarray:
    """The session's frames ``[n_recv, D]``: the device buffer row
    overlaid with any host-staged blocks not yet written (host-side
    ``n_recv`` is authoritative, so a snapshot never forces an upload)."""
    fr = np.zeros((sess.n_recv, pool.engine.input_dim), np.float32)
    if dev_row is not None and sess.n_recv:
        n_dev = min(sess.n_recv, dev_row.shape[0])
        fr[:n_dev] = dev_row[:n_dev]
    for slot, feats in pool._staged:
        if slot == k:
            fr[:feats.shape[0]] = feats
    for slot, start, feats in pool._staged_appends:
        if slot == k:
            fr[start:start + feats.shape[0]] = feats
    return fr


def _session_rows(pool: "SessionPool", sess,
                  out_row: Optional[np.ndarray]) -> np.ndarray:
    """The banked logits rows ``[0, cursor)`` — from the device output
    bank (chunked) or the host row list (per-frame)."""
    n_classes = pool.engine.n_classes
    if pool.chunk_frames:
        if out_row is None or not sess.cursor:
            return np.zeros((0, n_classes), np.float32)
        return np.array(out_row[:sess.cursor], np.float32)
    if not sess.rows:
        return np.zeros((0, n_classes), np.float32)
    return np.stack(sess.rows).astype(np.float32)


def _snap(pool: "SessionPool", sess, k: int, layer_rows, tel_col,
          frames_row, out_row) -> SessionSnapshot:
    arrays: Dict[str, np.ndarray] = {}
    for i, row in enumerate(layer_rows):
        for name, val in zip(_LAYER_FIELDS, row):
            arrays[f"layer{i}/{name}"] = np.array(val, np.float32)
    arrays["telemetry"] = np.asarray(np.stack(tel_col), np.float32)
    arrays["frames"] = _overlay_frames(pool, sess, k, frames_row)
    arrays["rows"] = _session_rows(pool, sess, out_row)
    return SessionSnapshot(meta=_session_meta(sess), arrays=arrays)


def _split(state_np: List[np.ndarray], n_layers: int):
    """PoolState tensors in ``PoolState.tensors()`` order -> (layers as
    ``[[s_hat, c, h, dm], ...]``, telemetry ``[nnz, ovf, steps]``,
    cursor)."""
    layers = [state_np[4 * i:4 * i + 4] for i in range(n_layers)]
    tel = state_np[4 * n_layers:4 * n_layers + 3]
    return layers, tel, state_np[4 * n_layers + 3]


def _fetch_pool(pool: "SessionPool", with_buffers: bool = True):
    """Every shard's state (and frames and logits bank) in ONE gathered
    fetch under the pool's state lock, the shards' blocks joined back
    over the pool's slots: (state arrays in ``PoolState.tensors()``
    order, frames, out) as numpy; frames and out are None without
    ``with_buffers`` (out also in per-frame mode)."""
    n_l = len(pool.engine.layers)
    with pool._state_lock:
        per = []
        for sh in pool._shards:
            ts = list(sh.state.tensors())
            if with_buffers:
                ts.append(sh.frames)
                if sh.out is not None:
                    ts.append(sh.out)
            per.append(ts)
        fetch = HostCopy(*(t for ts in per for t in ts))
    host = fetch.wait()
    host = [host] if isinstance(host, torch.Tensor) else host
    width = len(per[0])
    blocks = [host[i * width:(i + 1) * width] for i in range(len(per))]
    n_state = 4 * n_l + 4
    state = shardlib.join_pool_state(
        [PoolState.from_tensors(b[:n_state], n_l) for b in blocks])
    arrays = [t.numpy() for t in state.tensors()]
    frames = out = None
    if with_buffers:
        frames = torch.cat([b[n_state] for b in blocks]).numpy()
        if width > n_state + 1:
            out = torch.cat([b[n_state + 1] for b in blocks]).numpy()
    return arrays, frames, out


def snapshot_session(pool: "SessionPool", req_id: int) -> SessionSnapshot:
    """Serialize ONE live session (one gathered fetch of its rows).

    Raises KeyError for a request the pool has no live slot for — a
    session inside the retirement window is past snapshotting (its
    result is in flight; resolve it with ``flush()``)."""
    if req_id not in pool._by_req:
        raise KeyError(f"request {req_id} is not live in the pool")
    k = pool._by_req[req_id]
    sess = pool._slots[k]
    with pool._state_lock:
        sh = pool._shards[pool._shard_of(k)]
        j = k - sh.lo
        tensors = [getattr(st, f)[j] for st in sh.state.layers
                   for f in _LAYER_FIELDS]
        tensors += [t[:, j] for t in sh.state.telemetry]
        tensors.append(sh.frames[j])
        if sh.out is not None:
            tensors.append(sh.out[j])
        fetch = HostCopy(*tensors)
    host = fetch.numpy()
    n_l = len(pool.engine.layers)
    layer_rows = [host[4 * i:4 * i + 4] for i in range(n_l)]
    tel_col = host[4 * n_l:4 * n_l + 3]
    frames_row = host[4 * n_l + 3]
    out_row = host[4 * n_l + 4] if pool.chunk_frames else None
    return _snap(pool, sess, k, layer_rows, tel_col, frames_row, out_row)


def snapshot_pool(pool: "SessionPool") -> PoolCheckpoint:
    """Serialize every live session in ONE gathered device-to-host fetch
    of the pool's tensors (state, frames, out).  Sessions inside the
    retirement window are NOT included; call ``flush()`` first to
    resolve them.  Like the reference's, a snapshot reads the driver's
    host bookkeeping (slots, staged frames, cursors), so the thread that
    drives the pool takes it, between ticks."""
    host, frames, out = _fetch_pool(pool)
    layers, tel, _ = _split(host, len(pool.engine.layers))
    sessions: List[SessionSnapshot] = []
    for k, sess in enumerate(pool._slots):
        if sess is None:
            continue
        layer_rows = [[a[k] for a in rows] for rows in layers]
        tel_col = [t[:, k] for t in tel]
        sessions.append(_snap(pool, sess, k, layer_rows, tel_col,
                              frames[k], out[k] if out is not None else None))
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "engine": engine_fingerprint(pool.engine),
        "chunk_frames": int(pool.chunk_frames),
        "capacity": int(pool.capacity),
        "n_sessions": len(sessions),
    }
    return PoolCheckpoint(meta=meta, sessions=sessions)


# -- restore ------------------------------------------------------------------


def _make_session(pool: "SessionPool", snap: SessionSnapshot, k: int,
                  now_wall: float):
    from repro_torch.serving.scheduler import _Session

    m = snap.meta
    sess = _Session(
        req_id=int(m["req_id"]),
        arrival_step=int(m["arrival_step"]),
        admit_step=int(m["admit_step"]),
        arrival_wall=now_wall,
        admit_wall=now_wall,
        total=None if m["total"] is None else int(m["total"]),
        n_recv=int(m["n_recv"]),
        cursor=int(m["cursor"]),
        last_step=int(m["last_step"]),
        needs_reset=bool(m["needs_reset"]),
        partials_paused=bool(m["partials_paused"]),
        # wall clocks re-base to restore time: latency numbers measure
        # this process's service, not the epoch of the dead one
        first_logit_wall=now_wall if m["had_first_logit"] else 0.0,
    )
    if not pool.chunk_frames:
        sess.rows = [np.array(r) for r in snap.arrays["rows"]]
    pool._slots[k] = sess
    pool._by_req[sess.req_id] = k
    # frames ride the standard staged-upload wave at the next boundary; a
    # zero-length staging still resets the slot's device length
    pool._staged.append((k, np.asarray(snap.arrays["frames"], np.float32)))
    return sess


def _check_frames(pool: "SessionPool", n_recv: int, what: str) -> None:
    if n_recv > pool.max_buffer_frames:
        raise ValueError(
            f"{what} holds {n_recv} frames, past this pool's "
            f"max_buffer_frames={pool.max_buffer_frames}")


def restore_session(pool: "SessionPool", snap: SessionSnapshot) -> bool:
    """Restore ONE session into a free slot of a live pool (the
    single-session migration primitive).  Returns False if the pool is
    full; raises on a duplicate request id or an oversized snapshot.
    The slot's rows are written in place with ``index_copy_``."""
    m = snap.meta
    if int(m["req_id"]) in pool._by_req:
        raise ValueError(f"request {m['req_id']} is already in the pool")
    _check_frames(pool, int(m["n_recv"]), f"request {m['req_id']}: snapshot")
    k = pool._pick_slot()
    if k is None:
        return False
    with pool._state_lock:
        if int(m["n_recv"]) > pool._t_buf:
            pool._grow_buffers(int(m["n_recv"]))
        sess = _make_session(pool, snap, k, time.perf_counter())
        sh = pool._shards[pool._shard_of(k)]
        dev = sh.engine.device
        kk = upload(np.array([k - sh.lo], np.int64), dev)
        state = sh.state
        for i, st in enumerate(state.layers):
            for f in _LAYER_FIELDS:
                row = snap.arrays[f"layer{i}/{f}"].astype(np.float32)
                getattr(st, f).index_copy_(0, kk, upload(row[None], dev))
        tel = snap.arrays["telemetry"].astype(np.float32)
        for t, col in zip(state.telemetry, tel):
            t.index_copy_(1, kk, upload(col[:, None], dev))
        state.cursor.index_copy_(
            0, kk, upload(np.array([sess.cursor], np.int32), dev))
        if pool.chunk_frames:
            rows = snap.arrays["rows"]
            row_full = np.zeros((sh.out.shape[1], pool.engine.n_classes),
                                np.float32)
            row_full[:rows.shape[0]] = rows
            sh.out.index_copy_(0, kk, upload(row_full[None], dev))
    return True


def restore_into(pool: "SessionPool", ckpt: PoolCheckpoint) -> None:
    """Restore every session of a checkpoint into a FRESH, empty pool.

    The target pool may have another capacity than the writer: slot
    placement is re-derived by the pool's own admission policy.  The
    new state is assembled on the host on top of the fresh pool's values
    (so untouched slots keep their exact initial state) and copied into
    the pool's tensors in place; frames ride the standard staged-upload
    wave at the first boundary."""
    t0 = time.perf_counter()
    _check_engine(pool, ckpt.meta)
    if (pool.n_active or pool._staged or pool._staged_appends
            or pool.has_pending):
        raise ValueError("restore_into requires an empty pool with no "
                         "staged or pending work")
    if len(ckpt.sessions) > pool.capacity:
        raise ValueError(
            f"checkpoint holds {len(ckpt.sessions)} sessions, pool "
            f"capacity is {pool.capacity}")
    t_need = max((int(s.meta["n_recv"]) for s in ckpt.sessions), default=0)
    _check_frames(pool, t_need, "checkpoint session")
    with pool._state_lock:
        if t_need > pool._t_buf:
            pool._grow_buffers(t_need)
    base, _, _ = _fetch_pool(pool, with_buffers=False)
    host = [np.array(a) for a in base]
    layers, tel, cursor = _split(host, len(pool.engine.layers))
    out_np = (np.zeros((pool.capacity, pool._t_buf + pool.chunk_frames,
                        pool.engine.n_classes), np.float32)
              if pool.chunk_frames else None)

    now_wall = time.perf_counter()
    for snap in ckpt.sessions:
        if int(snap.meta["req_id"]) in pool._by_req:
            raise ValueError(f"duplicate request {snap.meta['req_id']} "
                             "in checkpoint")
        k = pool._pick_slot()
        assert k is not None  # capacity checked above
        sess = _make_session(pool, snap, k, now_wall)
        for i, rows in enumerate(layers):
            for f, arr in zip(_LAYER_FIELDS, rows):
                arr[k] = snap.arrays[f"layer{i}/{f}"]
        for j, t in enumerate(tel):
            t[:, k] = snap.arrays["telemetry"][j]
        cursor[k] = sess.cursor
        if out_np is not None:
            rows = snap.arrays["rows"]
            out_np[k, :rows.shape[0]] = rows

    with pool._state_lock:
        for sh in pool._shards:
            # each shard's block of the assembled arrays, written in place
            dev = sh.engine.device
            dims = shardlib.pool_state_slot_dims(sh.state).tensors()
            for t, arr, d in zip(sh.state.tensors(), host, dims):
                block = np.take(arr, range(sh.lo, sh.hi), axis=d)
                t.copy_(upload(block, dev))
            if out_np is not None:
                sh.out.copy_(upload(out_np[sh.lo:sh.hi], dev))
    if pool.obs is not None:
        pool.obs.fold_restore(n_sessions=len(ckpt.sessions),
                              seconds=time.perf_counter() - t0)


# -- file IO (rides training/checkpoint.py) -----------------------------------


def _flatten_ckpt(ckpt: PoolCheckpoint):
    arrays: Dict[str, np.ndarray] = {}
    metas: List[Dict[str, Any]] = []
    for i, snap in enumerate(ckpt.sessions):
        metas.append(snap.meta)
        for key, arr in snap.arrays.items():
            arrays[f"s{i}/{key}"] = arr
    meta = dict(ckpt.meta)
    meta["sessions"] = metas
    return arrays, meta


def _unflatten_ckpt(arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> PoolCheckpoint:
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} checkpoint: {meta.get('format')!r}")
    if int(meta.get("version", -1)) > VERSION:
        raise ValueError(f"checkpoint version {meta['version']} is newer "
                         f"than this code ({VERSION})")
    sessions = []
    for i, smeta in enumerate(meta["sessions"]):
        prefix = f"s{i}/"
        sarr = {k[len(prefix):]: np.asarray(v)
                for k, v in arrays.items() if k.startswith(prefix)}
        sessions.append(SessionSnapshot(meta=dict(smeta), arrays=sarr))
    pmeta = {k: v for k, v in meta.items() if k != "sessions"}
    return PoolCheckpoint(meta=pmeta, sessions=sessions)


def save_pool(pool: "SessionPool", path: str, *,
              keep_last: int = 3) -> List["RequestResult"]:
    """Checkpoint the whole pool to ``path`` (a checkpoint *directory*:
    atomic write, COMMIT marker, retention — `CheckpointManager`).

    Flushes the double-buffer tail first and RETURNS those finished
    results: their logits belong to the caller, not the checkpoint.  The
    checkpoint step number is the pool's dispatch count."""
    results = pool.flush()
    t0 = time.perf_counter()
    ckpt = snapshot_pool(pool)
    arrays, meta = _flatten_ckpt(ckpt)
    CheckpointManager(path, keep_last=keep_last).save(
        pool.n_dispatches, arrays, metadata=meta)
    if pool.obs is not None:
        pool.obs.fold_checkpoint(n_sessions=len(ckpt.sessions),
                                 seconds=time.perf_counter() - t0)
    return results


def load_checkpoint(path: str, step: Optional[int] = None) -> PoolCheckpoint:
    """Read a committed pool checkpoint back (latest step by default);
    incomplete checkpoints (no COMMIT marker) are never offered."""
    mgr = CheckpointManager(path)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
    arrays, meta = mgr.restore_arrays(step)
    return _unflatten_ckpt(arrays, meta)
