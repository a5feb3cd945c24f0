"""Optimizers & schedules — port of ``repro/training/optimizer.py``.

AdamW with global-norm clipping, plus warmup-cosine / linear / constant
schedules, written out as the reference writes them.  ``torch.optim.AdamW``
is not used: it places eps and the bias corrections differently, and it
neither clips nor schedules.  States are trees of tensors like the
parameters; the step, the learning rate and the norm stay 0-d tensors on
the parameters' device, so an update never waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import _tree


class AdamState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: object             # tree like params
    v: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    schedule: str = "constant"      # constant | cosine | linear
    warmup_steps: int = 0
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> learning rate (float32 tensor)."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        span = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        if cfg.schedule == "constant":
            decay = 1.0
        elif cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            decay = 1.0 - (1 - cfg.min_lr_frac) * frac
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * warm * decay

    return fn


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([
        torch.sum(torch.square(l.to(torch.float32)))
        for l in _tree.leaves(tree)]).sum())


def adamw_init(params) -> AdamState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = _tree.leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=_tree.tree_map(zeros, params),
                     v=_tree.tree_map(zeros, params))


def adamw_leaf_update(grads, step: torch.Tensor, cfg: AdamWConfig,
                      donate: bool = False):
    """The update's scalars, from the whole gradient tree: returns
    ``(upd, new step, metrics)`` where ``upd(g, m, v, p) -> (p, m, v)``
    updates one leaf, or any block of one (every operation is
    elementwise, so a block's update is the whole leaf's, bit for bit).
    The scalars follow each leaf to its device."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm is not None else None)

    step = step + 1
    lr = schedule_fn(cfg)(step)
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)
    on = {}

    def upd(g, m, v, p):
        if g.device not in on:
            on[g.device] = [s if s is None else s.to(g.device)
                            for s in (scale, lr, b1c, b2c)]
        scale_, lr_, b1c_, b2c_ = on[g.device]
        if scale_ is not None:    # global-norm clipping, one leaf at a time
            g = g.mul_(scale_) if donate else g * scale_
        g32 = g.to(torch.float32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        delta = (m_new / b1c_) / (torch.sqrt(v_new / b2c_) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr_ * delta).to(p.dtype)
        if not donate:
            return p_new, m_new, v_new
        return p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)

    return upd, step, {"grad_norm": gnorm, "lr": lr}


def adamw_update(grads, state: AdamState, params, cfg: AdamWConfig,
                 donate: bool = False):
    """Returns (new_params, new_state, metrics).

    With ``donate`` the update is written into ``params``, ``state.m`` and
    ``state.v`` (and the clipped gradient into ``grads``), which are
    returned, as the reference's jitted step donates its params and
    optimizer state: the old and the new state never coexist.  Every leaf
    takes the same arithmetic either way, so the two agree bit for bit."""
    upd, step, metrics = adamw_leaf_update(grads, state.step, cfg, donate)
    # trees are matched by leaf path, whatever their dicts' key order
    g, m, v = (dict(_tree.leaves_with_path(t))
               for t in (grads, state.m, state.v))
    out = {}
    with torch.no_grad():
        for path, p in _tree.leaves_with_path(params):
            out[path] = upd(g[path], m[path], v[path], p)
    new = [_tree.map_with_path(lambda path, _: out[path][i], params)
           for i in range(3)]
    return new[0], AdamState(step=step, m=new[1], v=new[2]), metrics
