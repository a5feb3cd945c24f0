"""Continuous-batching Spartus engine: all pool slots advance one frame
per step — port of ``repro/serving/batched_engine.py``.

The per-layer state of every session in a fixed-capacity pool is stored
as stacked device tensors (`BatchedLayerState`, shapes ``[B, ...]``), and
each step runs, for every layer,

    IPU   delta_encode_step             (one kernel launch for all slots)
    CTRL  select_active_columns_batch   (scatter route; the dense-mirror
    MACs  stsp_spmv_batch                route fuses both into
                                         delta_spmv_dense_topk_batch)
    HPE   lstm_pointwise_step           (one kernel launch for all slots)

plus the FCL/logit head.  An ``active`` mask freezes idle slots and a
``reset`` mask re-initialises admitted slots.  Telemetry accumulates on
the device.

`PoolState` is preallocated once and updated IN PLACE by every step:
that stands in for the reference's buffer donation, so the slabs are
reused tick over tick.  The IPU and HPE kernels write the layer state
themselves, only for active slots, in place of the reference's
concatenate, accumulate and masked ``where`` glue.  Every step entry
point therefore mutates the state it is given and returns the same
object.  No step syncs with the host, so a later change can capture a
chunk as a CUDA graph.

`step_batch` takes host-staged frames; `step_frames` gathers each slot's
frame from device-resident buffers by the device cursor; `step_chunk`
advances every slot up to C frames (a Python loop over the same core)
and banks each frame's logits in a per-slot device output buffer.

Host vectors (masks, cursors) reach the card through pinned memory with
``non_blocking=True``, and `snapshot_out` / `snapshot_chunk` stage their
rows into pinned host buffers behind the chunk with one CUDA event
(`HostCopy`): a dispatch never waits for the chunk before it, and the
pool's retirement fetch waits for that chunk's copy only.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, HostCopy, resolve_device, upload
from repro_torch.analysis.contracts import hotpath_contract
from repro_torch.kernels import ops
from repro_torch.models.lstm_am import LSTMAMConfig
from repro_torch.serving import telemetry as tele
from repro_torch.serving.engine import (
    EngineConfig, PackedSpartusModel, act_kwargs, active_quant,
)


class BatchedLayerState(NamedTuple):
    """Stacked per-slot state of one DeltaLSTM layer."""

    s_hat: torch.Tensor  # [B, D+H] concatenated x̂ / ĥ references
    c: torch.Tensor      # [B, H] cell state
    h: torch.Tensor      # [B, H] hidden state
    dm: torch.Tensor     # [B, 4H] delta memories


class PoolState(NamedTuple):
    """Full device-resident state of the session pool."""

    layers: Tuple[BatchedLayerState, ...]
    telemetry: tele.TelemetryState
    cursor: torch.Tensor  # [B] int32 per-slot frame cursor

    def tensors(self):
        for l in self.layers:
            yield from l
        yield from self.telemetry
        yield self.cursor

    @staticmethod
    def from_tensors(leaves, n_layers: int) -> "PoolState":
        """The inverse of ``tensors()``: ``leaves`` in its order."""
        leaves = list(leaves)
        return PoolState(
            layers=tuple(BatchedLayerState(*leaves[4 * i:4 * i + 4])
                         for i in range(n_layers)),
            telemetry=tele.TelemetryState(
                *leaves[4 * n_layers:4 * n_layers + 3]),
            cursor=leaves[4 * n_layers + 3])


class BatchedSpartusEngine(PackedSpartusModel):
    """Weight-resident multi-session engine: one CBCSC weight set, B
    independent streaming sessions multiplexed across it."""

    def __init__(self, am_params: Dict[str, Any], am_cfg: LSTMAMConfig,
                 cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        super().__init__(am_params, am_cfg, cfg, device)
        self._dm0 = [l.bias.to(torch.float32).reshape(-1)
                     for l in self.layers]
        # per-layer column counts on the device, for sync-free totals
        self._n_cols_dev = torch.tensor(self.n_cols, dtype=torch.float32,
                                        device=self.device)
        self._replicas: List["BatchedSpartusEngine"] = []

    def on(self, device: DeviceLike) -> "BatchedSpartusEngine":
        """This engine with its packed weights on ``device``: the engine
        itself when that is its own device, else a replica whose weights
        are copied there once, on the first call (a pool's slot shards
        each run on their own device; shards sharing a card share its
        weights)."""
        device = resolve_device(device)
        if device == self.device:
            return self
        for rep in self._replicas:
            if device == rep.device:
                return rep
        rep = copy.copy(self)
        rep.device = device
        rep.layers = [l.to(device) for l in self.layers]
        rep.fcl = {k: v.to(device) for k, v in self.fcl.items()}
        rep.logit = {k: v.to(device) for k, v in self.logit.items()}
        rep._dm0 = [t.to(device) for t in self._dm0]
        rep._n_cols_dev = self._n_cols_dev.to(device)
        rep._replicas = []
        self._replicas.append(rep)
        return rep

    # -- state management ----------------------------------------------------

    def init_state(self, n_slots: int) -> PoolState:
        kw = dict(dtype=torch.float32, device=self.device)
        layers = []
        for l, dm0 in zip(self.layers, self._dm0):
            d, h = l.input_dim, l.hidden_dim
            layers.append(BatchedLayerState(
                s_hat=torch.zeros((n_slots, d + h), **kw),
                c=torch.zeros((n_slots, h), **kw),
                h=torch.zeros((n_slots, h), **kw),
                dm=dm0.expand(n_slots, 4 * h).clone(),
            ))
        return PoolState(
            layers=tuple(layers),
            telemetry=tele.init_telemetry(len(self.layers), n_slots,
                                          self.device),
            cursor=torch.zeros((n_slots,), dtype=torch.int32,
                               device=self.device),
        )

    def init_out_buf(self, n_slots: int, t_buf: int) -> torch.Tensor:
        """Per-slot device logits buffer for the chunked tick loop."""
        return torch.zeros((n_slots, t_buf, self.n_classes),
                           dtype=torch.float32, device=self.device)

    def _apply_reset(self, state: PoolState, reset: torch.Tensor, *,
                     reset_cursor: bool) -> None:
        """Re-initialise reset slots' layer state (and optionally their
        cursor) in place — admission, applied once per dispatch."""
        rm = reset[:, None]
        for st, dm0 in zip(state.layers, self._dm0):
            st.s_hat.masked_fill_(rm, 0.0)
            st.c.masked_fill_(rm, 0.0)
            st.h.masked_fill_(rm, 0.0)
            st.dm.copy_(torch.where(rm, dm0, st.dm))
        if reset_cursor:
            state.cursor.masked_fill_(reset, 0)

    # -- the batched step ----------------------------------------------------

    def _step_core(self, state: PoolState, x: torch.Tensor,
                   active: torch.Tensor,
                   new_cursor: torch.Tensor) -> torch.Tensor:
        """Advance active slots one frame in place -> logits [B, C]."""
        cfg = self.cfg
        quant = active_quant(cfg) is not None
        nnz_layers, dropped_layers = [], []
        h = x
        for layer, st in zip(self.layers, state.layers):
            wscale = layer.scale if quant else None
            # IPU on [h | st.h], st.s_hat updated for active slots
            delta, nnz = ops.delta_encode_step(
                h, st.h, st.s_hat, cfg.theta, active=active,
                **act_kwargs(cfg))
            if layer.w_dense_t is not None:
                y, dropped = ops.delta_spmv_dense_topk_batch(
                    layer.w_dense_t, delta, layer.capacity, scale=wscale)
            else:
                idx, vals, dropped = ops.select_active_columns_batch(
                    delta, layer.capacity)
                y = ops.stsp_spmv_batch(layer.enc.val, layer.enc.lidx, idx,
                                        vals, s=layer.enc.s, scale=wscale)
            # dm += y and the HPE; st.dm, st.c, st.h updated for active
            # slots, h (every slot) is the next layer's input
            h = ops.lstm_pointwise_step(st.dm, y, st.c, st.h, active=active)
            nnz_layers.append(nnz)
            dropped_layers.append(dropped)
        tele.accumulate_layers(state.telemetry, torch.stack(nnz_layers),
                               torch.stack(dropped_layers), active)
        state.cursor.copy_(new_cursor)
        return self.head(h)

    def _dev(self, x, dtype: torch.dtype) -> torch.Tensor:
        """A per-slot host vector on the device with no host sync (pinned
        and non-blocking on a card: the pool's masks and cursors must not
        wait for the chunk still in flight); tensors pass through."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        np_dtype = {torch.bool: np.bool_, torch.int32: np.int32,
                    torch.float32: np.float32}[dtype]
        return upload(np.asarray(x, np_dtype), self.device)

    def _masks(self, active, reset: Optional[Any]):
        active = self._dev(active, torch.bool)
        reset = (torch.zeros_like(active) if reset is None
                 else self._dev(reset, torch.bool))
        return active, reset

    def step_batch(self, state: PoolState, x, active, reset=None
                   ) -> Tuple[PoolState, torch.Tensor]:
        """Advance every active slot one frame from host-staged frames.

        x [B, D] next frame per slot, active [B] slots that consume a
        frame, reset [B] slots to re-initialise first.  The cursor rides
        along untouched.  Returns (state, logits [B, n_classes]); rows of
        inactive slots are garbage."""
        active, reset = self._masks(active, reset)
        self._apply_reset(state, reset, reset_cursor=False)
        x = self._dev(x, torch.float32).contiguous()
        return state, self._step_core(state, x, active, state.cursor.clone())

    @hotpath_contract("step_frames", donates=("state",),
                      op_budget={"transpose": 0})
    def step_frames(self, state: PoolState, frames: torch.Tensor, active,
                    reset=None) -> Tuple[PoolState, torch.Tensor]:
        """Advance every active slot one frame from device-resident
        buffers ``frames [B, T_buf, D]``, each slot's frame selected by
        its device cursor (reset slots restart at 0)."""
        active, reset = self._masks(active, reset)
        self._apply_reset(state, reset, reset_cursor=True)
        x = ops.gather_frames(frames, state.cursor)
        new_cur = state.cursor + active.to(torch.int32)
        return state, self._step_core(state, x, active, new_cur)

    @hotpath_contract("step_chunk", donates=("state", "out_buf"),
                      op_budget={"transpose": 0, "dynamic-update-slice": 8})
    def step_chunk(self, state: PoolState, frames: torch.Tensor, lengths,
                   active, reset, out_buf: torch.Tensor, *, n_frames: int
                   ) -> Tuple[PoolState, torch.Tensor]:
        """Advance every active slot up to ``n_frames`` frames.

        frames [B, T_buf, D] device buffers; lengths [B] utterance length
        (a slot stops — state frozen, no telemetry — once its cursor
        reaches it); active [B] occupied slots; reset [B] slots admitted at
        this boundary; out_buf [B, T_pad, n_classes] with T_pad >=
        T_buf + n_frames: frame t of slot b lands in ``out_buf[b, t]``.
        Updates ``state`` and ``out_buf`` in place and returns both."""
        active, reset = self._masks(active, reset)
        lengths = self._dev(lengths, torch.int32)
        self._apply_reset(state, reset, reset_cursor=True)
        start = state.cursor.clone()
        rows = []
        for _ in range(int(n_frames)):
            act = active & (state.cursor < lengths)
            x = ops.gather_frames(frames, state.cursor)
            rows.append(self._step_core(state, x, act,
                                        state.cursor + act.to(torch.int32)))
        ops.bank_rows(out_buf, torch.stack(rows), start)
        return state, out_buf

    def snapshot_out(self, out_buf: torch.Tensor, slots=None,
                     n_rows: Optional[int] = None) -> HostCopy:
        """Retiring sessions' rows, fetched to the host behind the chunk
        that wrote them: ``out_buf[slots, :n_rows]`` (every slot and row
        by default) is copied into pinned host memory now, on the current
        stream, so the copy is ordered before the next chunk overwrites
        the buffer; ``.wait()`` on the result waits for that copy only
        (``[len(slots), n_rows, n_classes]``)."""
        src = out_buf if n_rows is None else out_buf[:, :int(n_rows)]
        if slots is not None:
            src = src.index_select(0, self._dev(slots, torch.int32))
        return HostCopy(src)

    def snapshot_chunk(self, out_buf: torch.Tensor, starts, *,
                       n_frames: int) -> HostCopy:
        """One chunk's rows for every slot, ``[B, n_frames, n_classes]``
        with row b = ``out_buf[b, starts[b]:starts[b] + n_frames]``,
        fetched to the host behind the chunk like ``snapshot_out``."""
        starts = self._dev(starts, torch.int32)
        return HostCopy(ops.gather_rows(out_buf, starts, int(n_frames)))

    # -- telemetry -----------------------------------------------------------

    def measured_sparsity(self, state: PoolState) -> Dict[str, float]:
        """Single host fetch of the device-resident accumulators."""
        return tele.measured_sparsity(state.telemetry, self.n_cols)

    def telemetry_totals(self, state: PoolState) -> torch.Tensor:
        """The ``[3]`` running totals, reduced on device (no host sync)."""
        return tele.fold_totals(state.telemetry, self._n_cols_dev)
