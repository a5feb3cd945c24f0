"""Representative cases for the hot-path contracts — port of
``repro/analysis/cases.py``.

A :class:`ContractCase` binds a registered contract name to a recipe
that builds the function and concrete arguments, with the same shapes,
engine configuration and pool wiring as the reference's cases (hidden=32,
gamma=0.75, m=4, a 4-slot pool, 4-frame chunks, NZI capacity 1.0).
``build_cases()`` returns the reference's 14 unsharded cases by the same
names; ``build_cases(width="full")`` builds them at the 2x1024 model's
widths (D=123, H=1024, 41 classes, gamma=0.9375, m=64, a 16-slot pool,
16-frame chunks), as ``chip_smoke.py`` checks them on the card, and
``include_sharded`` (the default) appends the reference's
``step_chunk/sharded-4dev``: a pool of twice the slots over 4 logical
shards (``launch.mesh.emulated_devices``), checked by
``contracts.check_shards`` as well.  At capacity 1.0 the dense route
never clips, so ``served_cases()`` adds the served routes again at the
capacity the port serves them.

The weights are the port's own seeded ``init_params`` (the reference's
``jax.random`` draws cannot be regenerated in torch) and the inputs are
seeded numpy draws; nothing a contract checks depends on their values.
The reference's ``stsp_spmv_batch/xla-scatter`` and ``/pallas`` cases
select two implementations; the port has one (the CUDA kernel, its plain
version on the CPU), so both names check the same call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (
    Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, upload
from repro_torch.analysis import hlo

# Test-scale model constants, the reference's (repro/analysis/cases.py)
INPUT_DIM = 20
HIDDEN = 32
CLASSES = 11
GAMMA = 0.75
M = 4
THETA = 0.05
LENS = (5, 9, 3, 12, 1, 7, 8, 2)


@dataclasses.dataclass(frozen=True)
class Width:
    """One model and pool size the cases are built at."""

    input_dim: int
    hidden: int
    classes: int
    gamma: float
    m: int
    theta: float
    slots: int         # pool capacity, and the batch of the op cases
    chunk: int         # frames per chunk
    max_frames: int
    lens: Tuple[int, ...]


WIDTHS = {
    "test": Width(INPUT_DIM, HIDDEN, CLASSES, GAMMA, M, THETA, slots=4,
                  chunk=4, max_frames=16, lens=LENS),
    # the paper's 2x1024 DeltaLSTM (configs.spartus_lstm.DELTA_LSTM_2L_1024H)
    # as chip_smoke.py serves it: capacity 16, 16-frame chunks
    "full": Width(123, 1024, 41, 0.9375, 64, 0.3, slots=16, chunk=16,
                  max_frames=64, lens=tuple(4 * n for n in LENS)),
}


@dataclasses.dataclass
class BuiltCase:
    """A callable plus concrete arguments, ready to trace.  A sharded
    chunk also carries each shard's per-slot storages and the op
    histogram of the unsharded chunk at the shard's batch
    (``contracts.check_shards``)."""

    fn: Any
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    shards: Tuple[FrozenSet[int], ...] = ()
    shard_histogram: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class ContractCase:
    """One (contract, representative arguments) pair for the checker.

    ``build`` returns fresh arguments on every call: checking a case runs
    the function once, which updates donated state in place.
    ``op_budget_override`` tightens the contract's budgets for this case
    only (the dense-mirror chunk, whose capacity never binds, must not
    sort)."""

    name: str
    contract: str
    build: Callable[[], BuiltCase]
    op_budget_override: Mapping[str, int] = dataclasses.field(
        default_factory=dict)


# -- engines (cached: packing is the expensive part) --------------------------


@functools.lru_cache(maxsize=None)
def _engine(width: Width, device: torch.device, spmv_path: str = "auto",
            quant: bool = False, capacity_frac: float = 1.0):
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models import lstm_am
    from repro_torch.serving import BatchedSpartusEngine, EngineConfig

    cfg = lstm_am.LSTMAMConfig(input_dim=width.input_dim,
                               hidden_dim=width.hidden, n_layers=2,
                               n_classes=width.classes)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu"),
        gamma=width.gamma, m=width.m)
    ecfg = EngineConfig(theta=width.theta, gamma=width.gamma, m=width.m,
                        capacity_frac=capacity_frac, spmv_path=spmv_path,
                        quant=QuantConfig() if quant else None)
    return BatchedSpartusEngine(params, cfg, ecfg, device=device)


def _normal(seed: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def _feats(width: Width) -> List[np.ndarray]:
    return [np.random.default_rng(800 + i).standard_normal(
        (t, width.input_dim)).astype(np.float32)
        for i, t in enumerate(width.lens)]


def _starts(width: Width, pattern: Sequence[int]) -> np.ndarray:
    """``pattern`` (the reference's 4-slot starts) cycled over the slots
    and scaled to the chunk."""
    return (np.resize(np.asarray(pattern, np.int32), width.slots)
            * (width.chunk // 4)).astype(np.int32)


# -- the pool-chunk recipe ----------------------------------------------------


def _mark_shard(i: int) -> None:
    hlo.mark(f"shard{i}")


def _chunk_case(pool) -> BuiltCase:
    """The chunk step exactly as ``SessionPool.step_chunk`` stages it,
    with the masks uploaded as the pool's boundary uploads them: one
    shard's ``step_chunk``, or the pool's own ``sharding.dispatch_chunk``
    over every shard, each shard's part of a trace its section
    (``hlo.mark``)."""
    from repro_torch.serving import sharding as shardlib

    pool._reap_cancelled()
    active, reset = pool._masks()
    pool._flush_uploads()
    parts = [(sh.engine, sh.state, sh.frames, sh.lengths,
              upload(active[sh.lo:sh.hi], sh.engine.device),
              upload(reset[sh.lo:sh.hi], sh.engine.device), sh.out)
             for sh in pool._shards]
    kwargs = {"n_frames": pool.chunk_frames}
    if len(parts) == 1:
        return BuiltCase(fn=parts[0][0].step_chunk, args=parts[0][1:],
                         kwargs=kwargs)
    engines, *args = zip(*parts)
    return BuiltCase(fn=shardlib.dispatch_chunk, args=tuple(args),
                     kwargs={**kwargs, "engines": engines,
                             "on_shard": _mark_shard})


def built_pool_chunk(engine: Any, feats: Sequence[np.ndarray], width: Width,
                     capacity: Optional[int] = None,
                     n_devices: Optional[int] = None) -> BuiltCase:
    """Admit ``feats`` (cycled) into every slot of a fresh SessionPool
    (``width.slots`` of them by default; sharded over ``n_devices``
    logical shards on the engine's device) and stage its chunk step as a
    serving run would."""
    from repro_torch.launch.mesh import emulated_devices
    from repro_torch.serving.scheduler import SessionPool, StreamRequest

    capacity = width.slots if capacity is None else capacity
    with emulated_devices(n_devices or 1):
        pool = SessionPool(engine, capacity=capacity,
                           max_frames=width.max_frames,
                           chunk_frames=width.chunk, n_devices=n_devices)
    for i in range(capacity):
        pool.admit(StreamRequest(100 + i, 0, feats[i % len(feats)]), 0)
    return _chunk_case(pool)


# -- per-contract case builders -----------------------------------------------


def _built_step_frames(width: Width, device: torch.device) -> BuiltCase:
    engine = _engine(width, device)
    b = width.slots
    return BuiltCase(
        fn=engine.step_frames,
        args=(engine.init_state(b), _normal(3, (b, 8, width.input_dim),
                                            device),
              torch.ones((b,), dtype=torch.bool, device=device),
              torch.zeros((b,), dtype=torch.bool, device=device)),
        kwargs={})


def _built_step_chunk(width: Width, device: torch.device, spmv_path: str,
                      quant: bool = False, capacity_frac: float = 1.0
                      ) -> BuiltCase:
    return built_pool_chunk(
        _engine(width, device, spmv_path, quant, capacity_frac),
        _feats(width)[:4], width)


def _built_step_chunk_restored(width: Width,
                               device: torch.device) -> BuiltCase:
    """The chunk step as staged by a pool REBUILT from a checkpoint (the
    watchdog-recovery / preemption-resume path, serving/checkpoint.py):
    the same call, shapes, donation and budgets as a fresh pool's."""
    from repro_torch.serving import checkpoint as ckptlib
    from repro_torch.serving.scheduler import SessionPool, StreamRequest

    engine = _engine(width, device)
    feats = _feats(width)[:4]
    kw = dict(capacity=width.slots, max_frames=width.max_frames,
              chunk_frames=width.chunk)
    pool = SessionPool(engine, **kw)
    for i in range(width.slots):
        pool.admit(StreamRequest(100 + i, 0, feats[i % len(feats)]), 0)
    pool.step_chunk(0)                      # mid-flight recurrent state
    ckpt = ckptlib.snapshot_pool(pool)
    pool2 = SessionPool(engine, **kw)
    ckptlib.restore_into(pool2, ckpt)
    return _chunk_case(pool2)


def _built_step_chunk_sharded(width: Width, device: torch.device,
                              n_shards: int = 4) -> BuiltCase:
    """The reference's sharded case: twice the slots (8 at test scale)
    over ``n_shards`` logical shards, with each shard's per-slot
    storages and the op histogram of the unsharded chunk at the shard's
    batch, which every shard's part of the trace must match."""
    engine = _engine(width, device)
    feats = _feats(width)
    capacity = 2 * width.slots
    per = dataclasses.replace(width, slots=capacity // n_shards)
    one = built_pool_chunk(engine, feats, per)
    _, trace = hlo.trace(one.fn, *one.args, **one.kwargs)
    built = built_pool_chunk(engine, feats, width, capacity=capacity,
                             n_devices=n_shards)
    state, frames, lengths, _, _, out = built.args
    built.shards = tuple(
        frozenset(t.untyped_storage().data_ptr()
                  for t in (*st.tensors(), fr, ln, o))
        for st, fr, ln, o in zip(state, frames, lengths, out))
    built.shard_histogram = dict(hlo.op_histogram(trace))
    return built


def _spmv_args(width: Width, device: torch.device, spmv_path: str,
               quant: bool = False, capacity_frac: float = 1.0):
    layer = _engine(width, device, spmv_path, quant, capacity_frac).layers[0]
    k = layer.capacity
    q = layer.input_dim + layer.hidden_dim
    idx = torch.arange(k, dtype=torch.int32, device=device).remainder(q)
    idx = idx.expand(width.slots, k).contiguous()
    return layer, idx, _normal(5, (width.slots, k), device)


def _built_spmv_scatter(width: Width, device: torch.device,
                        quant: bool = False, capacity_frac: float = 1.0
                        ) -> BuiltCase:
    from repro_torch.kernels import ops

    layer, idx, vals = _spmv_args(width, device, "scatter", quant,
                                  capacity_frac)
    kwargs: Dict[str, Any] = {"s": layer.enc.s}
    if quant:
        kwargs["scale"] = layer.scale   # int8 payload + epilogue dequant
    return BuiltCase(fn=ops.stsp_spmv_batch,
                     args=(layer.enc.val, layer.enc.lidx, idx, vals),
                     kwargs=kwargs)


def _built_spmv_dense(width: Width, device: torch.device,
                      quant: bool = False, capacity_frac: float = 1.0
                      ) -> BuiltCase:
    from repro_torch.kernels import ops

    layer = _engine(width, device, "dense", quant, capacity_frac).layers[0]
    delta = _normal(7, (width.slots, layer.w_dense_t.shape[0]), device)
    kwargs: Dict[str, Any] = {"capacity": layer.capacity}
    if quant:
        kwargs["scale"] = layer.scale
    return BuiltCase(fn=ops.delta_spmv_dense_topk_batch,
                     args=(layer.w_dense_t, delta), kwargs=kwargs)


def _built_fold_totals(width: Width, device: torch.device) -> BuiltCase:
    from repro_torch.serving import telemetry

    engine = _engine(width, device)
    return BuiltCase(fn=telemetry.fold_totals,
                     args=(engine.init_state(width.slots).telemetry,
                           engine._n_cols_dev),
                     kwargs={})


def _built_bank_rows(width: Width, device: torch.device) -> BuiltCase:
    from repro_torch.kernels import ops

    b, n = width.slots, width.chunk
    buf = torch.zeros((b, 4 * n, width.classes), dtype=torch.float32,
                      device=device)
    rows = _normal(9, (n, b, width.classes), device)
    start = torch.from_numpy(_starts(width, (0, 4, 8, 2))).to(device)
    return BuiltCase(fn=ops.bank_rows, args=(buf, rows, start), kwargs={})


def _built_gather_rows(width: Width, device: torch.device) -> BuiltCase:
    from repro_torch.kernels import ops

    b, n = width.slots, width.chunk
    buf = _normal(11, (b, 4 * n, width.classes), device)
    start = torch.from_numpy(_starts(width, (0, 4, 8, 2))).to(device)
    return BuiltCase(fn=ops.gather_rows, args=(buf, start), kwargs={"n": n})


def _built_gather_frames(width: Width, device: torch.device) -> BuiltCase:
    from repro_torch.kernels import ops

    frames = _normal(13, (width.slots, 8, width.input_dim), device)
    cursor = torch.from_numpy(np.resize(np.asarray(
        [0, 3, 7, 2], np.int32), width.slots)).to(device)
    return BuiltCase(fn=ops.gather_frames, args=(frames, cursor), kwargs={})


def build_cases(*, width: str = "test", device: DeviceLike = None,
                include_sharded: bool = True) -> List[ContractCase]:
    """The reference's 14 unsharded cases at ``width`` ("test" or "full")
    on ``device`` (``cuda`` by default), then, with ``include_sharded``,
    its ``step_chunk/sharded-4dev`` case on 4 logical shards.

    Importing the annotated modules registers the contracts themselves,
    so that happens before any lookup."""
    from repro_torch.kernels import ops  # noqa: F401  (registers contracts)
    from repro_torch.serving import batched_engine, telemetry  # noqa: F401

    w = WIDTHS[width]
    dev = resolve_device(device)

    def at(fn, *args, **kwargs):
        return functools.partial(fn, w, dev, *args, **kwargs)

    cases = [
        ContractCase("step_frames/unsharded", "step_frames",
                     at(_built_step_frames)),
        ContractCase("step_chunk/dense-mirror", "step_chunk",
                     at(_built_step_chunk, "auto"),
                     op_budget_override={"sort": 0}),
        ContractCase("step_chunk/scatter", "step_chunk",
                     at(_built_step_chunk, "scatter")),
        ContractCase("step_chunk/post-restore", "step_chunk",
                     at(_built_step_chunk_restored),
                     op_budget_override={"sort": 0}),
        ContractCase("stsp_spmv_batch/xla-scatter", "stsp_spmv_batch",
                     at(_built_spmv_scatter)),
        ContractCase("stsp_spmv_batch/pallas", "stsp_spmv_batch",
                     at(_built_spmv_scatter)),
        ContractCase("stsp_spmv_batch/dense-mirror", "delta_spmv_dense_topk",
                     at(_built_spmv_dense)),
        # quantized builds of the same hot paths: int8 weight payloads with
        # the scale-epilogue dequant must honour every fp32 clause
        ContractCase("step_chunk/quant-int8", "step_chunk",
                     at(_built_step_chunk, "auto", quant=True),
                     op_budget_override={"sort": 0}),
        ContractCase("stsp_spmv_batch/quant-scatter", "stsp_spmv_batch",
                     at(_built_spmv_scatter, quant=True)),
        ContractCase("stsp_spmv_batch/quant-dense-mirror",
                     "delta_spmv_dense_topk",
                     at(_built_spmv_dense, quant=True)),
        ContractCase("fold_totals", "fold_totals", at(_built_fold_totals)),
        ContractCase("bank_rows", "bank_rows", at(_built_bank_rows)),
        ContractCase("gather_rows", "gather_rows", at(_built_gather_rows)),
        ContractCase("gather_frames", "gather_frames",
                     at(_built_gather_frames)),
    ]
    if include_sharded:
        cases.append(ContractCase("step_chunk/sharded-4dev", "step_chunk",
                                  at(_built_step_chunk_sharded)))
    return cases


def served_cases(*, width: str = "test",
                 device: DeviceLike = None) -> List[ContractCase]:
    """The routes ``chip_smoke.py`` serves, again at the capacity it serves
    them (``EngineConfig().capacity_frac``, below every layer's Q), where
    the reference's cases (capacity 1.0) never clip: the dense-mirror
    chunk in fp32 and int8, the scatter chunk, and the dense route's op
    in fp32 and int8.  The dense-mirror chunks are held to the reference's
    ``sort: 0``, as its dense-mirror chunk cases are; every other clause
    is the contract's."""
    from repro_torch.serving import EngineConfig

    w = WIDTHS[width]
    dev = resolve_device(device)
    frac = EngineConfig().capacity_frac

    def at(fn, *args, **kwargs):
        return functools.partial(fn, w, dev, *args, capacity_frac=frac,
                                 **kwargs)

    return [
        ContractCase("step_chunk/dense-mirror@served", "step_chunk",
                     at(_built_step_chunk, "auto"),
                     op_budget_override={"sort": 0}),
        ContractCase("step_chunk/quant-int8@served", "step_chunk",
                     at(_built_step_chunk, "auto", quant=True),
                     op_budget_override={"sort": 0}),
        ContractCase("step_chunk/scatter@served", "step_chunk",
                     at(_built_step_chunk, "scatter")),
        ContractCase("stsp_spmv_batch/dense-mirror@served",
                     "delta_spmv_dense_topk", at(_built_spmv_dense)),
        ContractCase("stsp_spmv_batch/quant-dense-mirror@served",
                     "delta_spmv_dense_topk", at(_built_spmv_dense,
                                                 quant=True)),
    ]
