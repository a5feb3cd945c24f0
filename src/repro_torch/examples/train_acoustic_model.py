"""End-to-end training run: a ~100M-parameter LSTM acoustic model with the
paper's full spatio-temporal pipeline for a few hundred steps, with
fault-tolerant checkpointing (kill it mid-run and re-launch: it resumes)
— port of ``examples/train_acoustic_model.py``.

    python -m repro_torch.examples.train_acoustic_model \\
        [--small] [--steps-per-epoch 50] [--ckpt DIR] [--device cpu]

--small uses a 2L-64H model (~100k params, seconds per epoch on the CPU);
the default 4L-1024H is the ~100M-parameter configuration (4*1024*2048*4
+ FCL/logit ~ 100M).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.data.speech import SpeechConfig, SpeechDataset
from repro_torch.models import lstm_am
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import (
    TrainConfig, evaluate_per, measure_delta_stats, pretrain_retrain,
)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--pretrain-epochs", type=int, default=4)
    ap.add_argument("--retrain-epochs", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.94)
    ap.add_argument("--theta", type=float, default=0.2)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    hidden, layers, m = (64, 2, 8) if args.small else (1024, 4, 64)
    cfg = TrainConfig(
        model=lstm_am.LSTMAMConfig(input_dim=123, hidden_dim=hidden,
                                   n_layers=layers, n_classes=11),
        data=SpeechConfig(max_frames=args.frames, n_classes=10,
                          avg_segment=12, tau=0.9),
        opt=AdamWConfig(lr=2e-3, schedule="cosine",
                        total_steps=args.steps_per_epoch
                        * (args.pretrain_epochs + args.retrain_epochs)),
        batch_size=16,
        steps_per_epoch=args.steps_per_epoch,
        cbtd_gamma=args.gamma,
        cbtd_m=m,
        cbtd_delta_alpha=1.0 / max(args.pretrain_epochs - 1, 1),
        ckpt_dir=args.ckpt,
        ckpt_every=args.steps_per_epoch,
    )
    n = lstm_am.n_params(lstm_am.init_params(torch.Generator().manual_seed(0),
                                             cfg.model, device=args.device))
    print(f"model: {cfg.model.name}  ({n/1e6:.1f} M params)")

    pre, post, rcfg = pretrain_retrain(
        cfg, args.pretrain_epochs, args.retrain_epochs, theta=args.theta,
        device=args.device)
    per = evaluate_per(post.params, rcfg, SpeechDataset(cfg.data, 16))
    stats = measure_delta_stats(post.params, rcfg,
                                SpeechDataset(rcfg.data, 8))
    print(f"pretrain loss {pre.final_loss:.3f} | retrain loss "
          f"{post.final_loss:.3f} | PER {per:.3f}")
    for li in range(rcfg.model.n_layers):
        s = stats[f"layer{li}"]
        print(f"  layer{li}: temporal sparsity dx "
              f"{s['temporal_sparsity_dx']:.1%} dh "
              f"{s['temporal_sparsity_dh']:.1%}")
    return {"n_params": n, "pretrain_loss": pre.final_loss,
            "retrain_loss": post.final_loss, "per": per,
            "steps": pre.steps + post.steps}


if __name__ == "__main__":
    main()
