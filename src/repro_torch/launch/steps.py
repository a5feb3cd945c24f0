"""Train/serve step builders — port of ``repro/launch/steps.py``: the
functions the launchers execute.

``q_chunk`` auto-selects for long sequences so 32k prefill never builds
an [S, S] score tile; training uses per-layer remat by default
(``torch.utils.checkpoint`` over each layer of the stack).

A train step takes ``(params, opt_state, batch)`` and returns ``(params,
opt_state, metrics)`` with every metric a 0-d tensor on the device: it
makes no host sync.  It donates its params and optimizer state, as the
reference's launcher jits it with ``donate_argnums=(0, 1)``: the update
is written into them (``adamw_update(..., donate=True)``).

Params and optimizer state placed on a mesh of several devices
(`ShardedTensor` leaves, ``distributed/sharding.py``) take the sharded
step, the single-controller counterpart of the reference's GSPMD step
over data-parallel replicas:

  1. gather every leaf whole onto each data replica's compute device
     (``launch.mesh.replica_devices``: the mesh device at (d, 0, ...));
  2. run ``loss_and_grads`` (its microbatches too) on that replica's
     slice of the batch, as ``batch_spec`` cuts it; a batch the data size
     D does not divide is replicated, as the reference's rule says, and
     computed once;
  3. sum the replicas' losses and gradients in the fixed order d = 0 ..
     D-1 on the first replica's device, then divide by D;
  4. take AdamW's global norm on the reduced whole gradients (a norm
     summed over shards would count a replicated block once per copy);
  5. split each gradient by its leaf's spec and update every shard in
     place (the step counter is replicated: every device holds the same
     copy).

At D = 1 gather and split copy exactly and the compute runs on the whole
batch in the one-device order, so the sharded step is bit-equal to the
one-device step.  The "model" axis shards storage only: no matmul is
split over it, and every replica gathers the whole tree at once; both
are speed work (ROADMAP.md queue 2), as is issuing the replicas' work
from one host thread.

The abstract builders return trees of ``meta`` tensors, shapes and
dtypes with no memory behind them (the reference's ``jax.eval_shape``).
"""
from __future__ import annotations

import os

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import _tree
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              batch_spec, gather)
from repro_torch.launch.mesh import replica_devices
from repro_torch.models import api
from repro_torch.models.config import ArchConfig, ShapeCell
from repro_torch.training.optimizer import (AdamState, AdamWConfig,
                                            adamw_init, adamw_leaf_update,
                                            adamw_update)


def pick_q_chunk(seq_len: int) -> int:
    if seq_len >= 32768:
        return 512
    if seq_len >= 4096:
        return 1024
    return 0


def pick_microbatches(cfg: ArchConfig, cell) -> int:
    """Gradient-accumulation factor: bound per-device activation memory.

    One microbatch per ~2 GiB of (layers x B x S x d) bf16 checkpoint
    volume at 256-way sharding, times a family factor for state the
    residual-checkpoint estimate misses (the reference's calibration).
    ``REPRO_MICROBATCHES`` overrides it, as in the reference."""
    if os.environ.get("REPRO_MICROBATCHES"):
        return int(os.environ["REPRO_MICROBATCHES"])
    factor = {"hybrid": 4.0, "audio": 64.0, "moe": 16.0}.get(cfg.family, 1.0)
    ckpt_bytes = (2 * cfg.n_layers * cell.global_batch * cell.seq_len
                  * cfg.d_model * factor)
    per_dev = ckpt_bytes / 256
    n_mb = 1
    while per_dev / n_mb > 2 * 1024**3 and n_mb < cell.global_batch:
        n_mb *= 2
    return n_mb


def make_loss_and_grads(cfg: ArchConfig, seq_len: int, remat: bool = True,
                        microbatches: int = 1):
    """``(params, batch) -> (loss, grads)``: ``jax.value_and_grad`` of the
    family's ``train_loss``.  With ``microbatches`` n the batch splits
    along dim 0 into n equal parts whose losses and gradients are summed
    in order from zero, then divided by n (the reference's ``lax.scan``).
    A leaf the loss does not reach gets a zero gradient."""
    q_chunk = pick_q_chunk(seq_len)

    def value_and_grad(params, batch):
        paths, leaves = zip(*_tree.leaves_with_path(params))
        live = [p.detach().requires_grad_(True) for p in leaves]
        by_path = dict(zip(paths, live))
        tree = _tree.map_with_path(lambda path, _: by_path[path], params)
        loss = api.train_loss(tree, cfg, batch, q_chunk=q_chunk, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = {path: (g if g is not None else torch.zeros_like(p))
                 for path, g, p in zip(paths, grads, leaves)}
        return loss.detach(), _tree.map_with_path(
            lambda path, _: grads[path], params)

    def loss_and_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                             + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(microbatches)]
        loss = torch.zeros((), dtype=torch.float32,
                           device=_tree.leaves(params)[0].device)
        acc = _tree.tree_map(torch.zeros_like, params)
        for mb in mbs:
            mb_loss, g = value_and_grad(params, mb)
            loss = loss + mb_loss
            acc = _tree.tree_map(torch.Tensor.add_, acc, g)
            del g
        return (loss / microbatches,
                _tree.tree_map(lambda a: a.div_(microbatches), acc))

    return loss_and_grads


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, seq_len: int,
                    remat: bool = True, microbatches: int = 1):
    loss_and_grads = make_loss_and_grads(cfg, seq_len, remat, microbatches)

    def train_step(params, opt_state, batch):
        leaf = _tree.leaves(params)[0]
        if isinstance(leaf, ShardedTensor):
            return _sharded_step(loss_and_grads, opt_cfg, leaf.mesh, params,
                                 opt_state, batch)
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg, donate=True)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def _replica_batches(batch, mesh, devices):
    """Each replica's slice of ``batch`` on its device, as ``batch_spec``
    cuts dim 0; one slice, the whole batch, where it replicates."""
    first = next(iter(batch.values()))
    if batch_spec(tuple(first.shape), mesh)[0] is None:
        devices = devices[:1]
    return [{k: v.tensor_split(len(devices))[d].to(dev)
             for k, v in batch.items()} for d, dev in enumerate(devices)]


def _sharded_step(loss_and_grads, opt_cfg, mesh, params, opt_state, batch):
    """One train step over `ShardedTensor` params and optimizer state (see
    the module docstring); the shards are updated in place and
    returned."""
    devices = replica_devices(mesh)
    losses, grads = [], []
    for dev, part in zip(devices, _replica_batches(batch, mesh, devices)):
        whole = _tree.tree_map(lambda x: gather(x, dev), params)
        loss, g = loss_and_grads(whole, part)
        del whole
        losses.append(loss)
        grads.append(g)
    home = devices[0]
    loss = losses[0]
    grads = grads[0] if len(grads) == 1 else _tree.tree_map(
        lambda *gs: _ordered_mean([g.to(home) for g in gs]), *grads)
    if len(losses) > 1:
        loss = _ordered_mean([x.to(home) for x in losses])

    upd, step, metrics = adamw_leaf_update(grads, gather(opt_state.step, home),
                                           opt_cfg, donate=True)
    g, m, v = (dict(_tree.leaves_with_path(t))
               for t in (grads, opt_state.m, opt_state.v))
    with torch.no_grad():
        for path, p in _tree.leaves_with_path(params):
            blocks = NamedSharding(p.mesh, p.spec).place(g.pop(path)).shards
            for g_k, m_k, v_k, p_k in zip(blocks, m[path].shards,
                                          v[path].shards, p.shards):
                upd(g_k, m_k, v_k, p_k)
    sp = opt_state.step
    step = NamedSharding(sp.mesh, sp.spec).place(step)
    return params, AdamState(step, opt_state.m, opt_state.v), {
        "loss": loss, **metrics}


def _ordered_mean(xs):
    """``(x_0 + x_1 + ... + x_{D-1}) / D``, summed in that order."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc.add_(x)
    return acc.div_(len(xs))


def _is_weight(leaf) -> bool:
    return leaf.ndim >= 2 and leaf.dtype.is_floating_point


def quantize_params_abstract(params_abs):
    """Abstract int8 serving tree: {'q': int8 weights (+passthrough),
    'scales': per-weight scalar}, as ``meta`` tensors."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    q = _tree.tree_map(
        lambda l: meta(l.shape, torch.int8) if _is_weight(l) else l,
        params_abs)
    scales = _tree.tree_map(
        lambda l: meta((), torch.float32) if _is_weight(l)
        else meta((0,), torch.float32), params_abs)
    return {"q": q, "scales": scales}


def dequantize_params(pq, dtype=torch.bfloat16):
    def one(q, s):
        if q.dtype == torch.int8:
            return q.to(dtype) * s.to(dtype)
        return q

    return _tree.tree_map(one, pq["q"], pq["scales"])


def make_serve_step(cfg: ArchConfig):
    from repro_torch import perf

    if perf.current().int8_weights:
        def serve_step(pq, cache, inputs):
            params = dequantize_params(pq)
            return api.serve_step(params, cfg, inputs, cache)
    else:
        def serve_step(params, cache, inputs):
            return api.serve_step(params, cfg, inputs, cache)

    return serve_step


def make_prefill_step(cfg: ArchConfig, seq_len: int):
    q_chunk = pick_q_chunk(seq_len)

    def prefill_step(params, inputs):
        return api.prefill(params, cfg, inputs, q_chunk=q_chunk)

    return prefill_step


# -- abstract state builders (no allocation) -----------------------------------


def _as_meta(tree):
    return _tree.tree_map(
        lambda l: torch.empty(tuple(l.shape), dtype=l.dtype, device="meta"),
        tree)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """``init_params``' tree as ``meta`` tensors: the real initialisation
    runs under a ``FakeTensorMode``, which records shapes and dtypes,
    allocates nothing and leaves the generator untouched."""
    with FakeTensorMode():
        fake = api.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                               device="cpu")
    return _as_meta(fake)


def abstract_opt_state(params_abs):
    return adamw_init(params_abs)


def abstract_cache(cfg: ArchConfig, cell: ShapeCell, dtype=torch.bfloat16):
    return api.init_cache(cfg, cell.global_batch, cell.seq_len, dtype,
                          device="meta")


def n_params_of(tree_abs) -> int:
    return sum(l.numel() for l in _tree.leaves(tree_abs))
