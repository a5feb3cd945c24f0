"""The paper's two-phase training procedure (Sec. V-C) as a fault-tolerant
trainer; port of ``repro/training/trainer.py``.

Phase 1 — *pretrain*: plain LSTM + CBTD applied after every parameter
update (Alg. 2), alpha annealed 0 -> 1 by ``delta_alpha`` per epoch.
Phase 2 — *retrain*: weights copied into DeltaLSTM layers of the same
size, trained with alpha = 1 and a fixed delta threshold Theta.

The step is a plain function on tensors: the port's ``lstm_am.forward``
(differentiable PyTorch ops; the serving kernels have no backward and are
never called here), CTC, ``torch.autograd.grad``, AdamW, then CBTD under
``torch.no_grad()``.  Parameters and optimizer state live on the
trainer's device (``cuda`` unless the caller passes ``device="cpu"``);
the synthetic batches are made on the host and uploaded.

As in the reference, the deterministic CBTD path drops nothing until
alpha reaches 1, and ``alpha_at(0, .)`` is 0: a retrain's first epoch
prunes nothing, even at ``cbtd_delta_alpha=1``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch._device import (
    DeviceLike,
    require_full_fp32_matmul,
    resolve_device,
    upload,
)
from repro_torch.core import alpha_at, cbtd_prune_tree, summarize_delta_aux
from repro_torch.core.cbtd import CBTDConfig
from repro_torch.data.speech import SpeechConfig, SpeechDataset
from repro_torch.models import lstm_am
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.ctc import ctc_loss, greedy_decode, phone_error_rate
from repro_torch.training.optimizer import (
    AdamState,
    AdamWConfig,
    adamw_init,
    adamw_update,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: lstm_am.LSTMAMConfig = lstm_am.LSTMAMConfig(hidden_dim=64,
                                                       n_layers=2)
    data: SpeechConfig = SpeechConfig()
    opt: AdamWConfig = AdamWConfig(lr=3e-3)
    batch_size: int = 16
    steps_per_epoch: int = 25
    # CBTD (Alg. 2)
    cbtd_gamma: Optional[float] = 0.94
    cbtd_m: int = 64
    cbtd_delta_alpha: float = 1.0 / 30.0
    cbtd_stochastic: bool = False   # alpha<1 stochastic drops (paper) vs determ.
    # checkpointing
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    seed: int = 0


def _cbtd_layout(cfg: TrainConfig) -> Optional[Dict[str, CBTDConfig]]:
    if cfg.cbtd_gamma is None:
        return None
    c = CBTDConfig(gamma=cfg.cbtd_gamma, m=cfg.cbtd_m,
                   delta_alpha=cfg.cbtd_delta_alpha)
    return {"w_x": c, "w_h": c, "fcl/w": c}


def loss_and_grads(params, cfg: TrainConfig, batch
                   ) -> Tuple[torch.Tensor, Any]:
    """CTC loss of ``params`` on ``batch`` (feats, feat_lens, labels,
    label_lens) and its gradient, a tree like ``params``."""
    leaves = _tree.leaves_with_path(params)
    live = {path: p.detach().requires_grad_(True) for path, p in leaves}
    feats, feat_lens, labels, label_lens = batch
    with torch.enable_grad():
        logits, _ = lstm_am.forward(
            _tree.map_with_path(lambda path, _: live[path], params),
            cfg.model, feats)
        loss = ctc_loss(logits, labels, feat_lens, label_lens)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    by_path = {path: (torch.zeros_like(live[path]) if g is None else g)
               for path, g in zip(live, grads)}
    return loss.detach(), _tree.map_with_path(
        lambda path, _: by_path[path], params)


def make_train_step(cfg: TrainConfig):
    """``train_step(params, opt_state, batch, alpha, generator=None) ->
    (params, opt_state, metrics)``; metrics' values are 0-d tensors on
    the parameters' device."""
    layout = _cbtd_layout(cfg)

    def train_step(params, opt_state: AdamState, batch, alpha: float,
                   generator: Optional[torch.Generator] = None):
        loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, cfg.opt)
            if layout is not None:
                params = cbtd_prune_tree(
                    params, layout, alpha,
                    generator if cfg.cbtd_stochastic else None)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def eval_logits(params, cfg: lstm_am.LSTMAMConfig, feats: torch.Tensor):
    with torch.no_grad():
        return lstm_am.forward(params, cfg, feats, collect_aux=True)


def _device_of(params) -> torch.device:
    return _tree.leaves(params)[0].device


def _upload(batch, device: torch.device):
    return tuple(upload(t.numpy(), device) for t in batch)


def evaluate_per(params, cfg: TrainConfig, dataset: SpeechDataset,
                 n_batches: int = 4) -> float:
    """Greedy-decode PER on freshly drawn eval batches (paper Sec. V-B)."""
    device = _device_of(params)
    hyps, refs = [], []
    # a disjoint held-out stream of the same distribution
    eval_ds = SpeechDataset(cfg.data, dataset.batch, process_index=10_000)
    for _ in range(n_batches):
        feats, feat_lens, labels, label_lens = next(eval_ds)
        logits, _ = eval_logits(params, cfg.model, upload(feats.numpy(),
                                                          device))
        hyps += greedy_decode(logits, feat_lens)
        refs += [labels[b, :int(label_lens[b])].tolist()
                 for b in range(labels.shape[0])]
    return phone_error_rate(hyps, refs)


def measure_delta_stats(params, cfg: TrainConfig, dataset: SpeechDataset,
                        n_batches: int = 2) -> Dict[str, Any]:
    """Run the DeltaLSTM forward collecting delta occupancy (Fig. 13a)."""
    if not cfg.model.delta:
        raise ValueError("delta stats need a DeltaLSTM model config")
    device = _device_of(params)
    per_layer: Dict[int, Dict[str, list]] = {}
    for _ in range(n_batches):
        feats, *_ = next(dataset)
        _, aux = eval_logits(params, cfg.model, upload(feats.numpy(), device))
        for li, layer_aux in enumerate(aux["layers"]):
            d = per_layer.setdefault(li, {"nnz_dx": [], "nnz_dh": [],
                                          "dx_masks": [], "dh_masks": []})
            for k in d:
                d[k].append(layer_aux[k])
    stats = {}
    dims = ([cfg.model.input_dim]
            + [cfg.model.hidden_dim] * (cfg.model.n_layers - 1))
    for li, d in per_layer.items():
        nnz_dx = torch.cat([a.reshape(-1) for a in d["nnz_dx"]])
        nnz_dh = torch.cat([a.reshape(-1) for a in d["nnz_dh"]])
        stats[f"layer{li}"] = summarize_delta_aux(
            {"nnz_dx": nnz_dx, "nnz_dh": nnz_dh}, dims[li],
            cfg.model.hidden_dim)
        # masks for balance-ratio analysis: [T', F] per layer
        for key in ("dx_masks", "dh_masks"):
            stats[f"layer{li}"][key] = torch.cat(
                [m.reshape(-1, m.shape[-1]) for m in d[key]])
    return stats


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: list
    final_loss: float
    steps: int
    wall_s: float
    # host wall time of each step, ending when its loss reached the host
    # (which waits for the step's device work)
    step_s: List[float] = dataclasses.field(default_factory=list)


def _step_generator(seed: int, step: int, device: torch.device
                    ) -> torch.Generator:
    """The stochastic CBTD draws of one step, seeded from (seed, step) so
    that a resumed run draws what the uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def train(cfg: TrainConfig, epochs: int = 2, params: Any = None,
          resume: bool = True, log_every: int = 0,
          device: DeviceLike = None) -> TrainResult:
    """Run the training loop (one phase) on ``device``.  Checkpoint/
    restart-safe: if ``cfg.ckpt_dir`` is set and a committed checkpoint
    exists, training resumes from it (params, optimizer, data-iterator
    position, epoch)."""
    device = resolve_device(device)
    require_full_fp32_matmul(device)
    if params is None:
        params = lstm_am.init_params(torch.Generator().manual_seed(cfg.seed),
                                     cfg.model, device=device)
    else:
        params = _tree.tree_map(lambda p: p.detach().to(device), params)
    opt_state = adamw_init(params)
    dataset = SpeechDataset(cfg.data, cfg.batch_size)
    step = 0

    mgr = None
    if cfg.ckpt_dir:
        mgr = CheckpointManager(cfg.ckpt_dir, keep_last=2, process_index=0,
                                async_save=True)
        if resume:
            (params, opt_state), meta, ck_step = mgr.restore_latest(
                (params, opt_state))
            if ck_step is not None:
                step = int(meta.get("step", ck_step))
                dataset.load_state_dict({"step": meta.get("data_step", step)})

    train_step = make_train_step(cfg)
    losses, step_s = [], []
    t0 = time.time()
    total_steps = epochs * cfg.steps_per_epoch
    while step < total_steps:
        t_step = time.perf_counter()
        epoch = step // cfg.steps_per_epoch
        alpha = alpha_at(epoch, cfg.cbtd_delta_alpha) if cfg.cbtd_gamma else 0.0
        batch = _upload(next(dataset), device)
        gen = (_step_generator(cfg.seed, step, device)
               if cfg.cbtd_stochastic else None)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                alpha, gen)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        step += 1
        if log_every and step % log_every == 0:
            print(f"step {step:5d} epoch {epoch:3d} alpha {alpha:.2f} "
                  f"loss {losses[-1]:.4f}")
        if mgr and step % cfg.ckpt_every == 0:
            mgr.save(step, (params, opt_state),
                     {"step": step, "data_step": dataset.step})
    if mgr:
        mgr.save(total_steps, (params, opt_state),
                 {"step": total_steps, "data_step": dataset.step})
        mgr.wait()
    tail = losses[-5:]
    return TrainResult(
        params=params, opt_state=opt_state, losses=losses,
        final_loss=sum(tail) / len(tail) if tail else float("nan"),
        steps=step, wall_s=time.time() - t0, step_s=step_s)


def pretrain_retrain(cfg: TrainConfig, pretrain_epochs: int = 2,
                     retrain_epochs: int = 1, theta: float = 0.1,
                     device: DeviceLike = None
                     ) -> Tuple[TrainResult, TrainResult, TrainConfig]:
    """The paper's full pipeline: LSTM+CBTD pretrain, then DeltaLSTM
    retrain with alpha=1 (Sec. V-C).  Returns both results + the retrain
    config."""
    pre = train(cfg, epochs=pretrain_epochs, device=device)
    retrain_cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, delta=True, theta=theta),
        cbtd_delta_alpha=1.0,  # alpha = 1 from the second retrain epoch on
    )
    post = train(retrain_cfg, epochs=retrain_epochs, params=pre.params,
                 device=device)
    return pre, post, retrain_cfg
