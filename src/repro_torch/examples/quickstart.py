"""Quickstart: the paper's full pipeline in miniature — port of
``examples/quickstart.py``.

1. pretrain a small LSTM acoustic model with CBTD structured pruning,
2. retrain it as a DeltaLSTM (temporal sparsity),
3. export to CBCSC and stream an utterance through the Spartus engine,
4. report the measured spatio-temporal sparsity, op savings, and the
   modelled accelerator speedup (Table IV style).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core import op_saving, tree_weight_sparsity
from repro_torch.data.speech import SpeechConfig, SpeechDataset
from repro_torch.hwsim import spartus_model as hw
from repro_torch.models import lstm_am
from repro_torch.serving.engine import EngineConfig, SpartusEngine
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import (
    TrainConfig, evaluate_per, pretrain_retrain,
)

GAMMA, THETA, M = 0.75, 0.2, 8


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--steps-per-epoch", type=int, default=60)
    ap.add_argument("--pretrain-epochs", type=int, default=3)
    ap.add_argument("--retrain-epochs", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = TrainConfig(
        model=lstm_am.LSTMAMConfig(input_dim=123, hidden_dim=args.hidden,
                                   n_layers=2, n_classes=11),
        data=SpeechConfig(max_frames=args.frames, n_classes=10,
                          avg_segment=12, tau=0.9),
        opt=AdamWConfig(lr=5e-3),
        batch_size=16,
        steps_per_epoch=args.steps_per_epoch,
        cbtd_gamma=GAMMA,
        cbtd_m=M,
        cbtd_delta_alpha=0.5,
    )

    print(f"== 1/2: pretrain LSTM+CBTD (gamma={GAMMA}), retrain DeltaLSTM "
          f"(theta={THETA}) ==")
    pre, post, retrain_cfg = pretrain_retrain(
        cfg, pretrain_epochs=args.pretrain_epochs,
        retrain_epochs=args.retrain_epochs, theta=THETA, device=args.device)
    ws = tree_weight_sparsity({"x": [l["w_x"] for l in post.params["lstm"]],
                               "h": [l["w_h"] for l in post.params["lstm"]]})
    per = evaluate_per(post.params, retrain_cfg, SpeechDataset(cfg.data, 16))
    print(f"   pretrain loss {pre.final_loss:.3f} -> retrain loss "
          f"{post.final_loss:.3f}; weight sparsity {ws:.1%}; PER {per:.3f}")

    print("== 3: CBCSC export + Spartus streaming engine ==")
    engine = SpartusEngine(post.params, retrain_cfg.model,
                           EngineConfig(theta=THETA, gamma=GAMMA, m=M),
                           device=args.device)
    feats, *_ = next(SpeechDataset(cfg.data, 1))
    logits = engine.run_utterance(feats[0])
    sp = engine.measured_sparsity()
    print(f"   streamed {logits.shape[0]} frames; temporal sparsity "
          f"{sp['temporal_sparsity']:.1%}; capacity overflow "
          f"{sp['capacity_overflow_rate']:.1%}")

    print("== 4: op savings + modelled hardware (Table IV style) ==")
    saving = op_saving(ws, sp["temporal_sparsity"])
    print(f"   arithmetic op saving: {saving:.1f}x "
          f"(paper at gamma=0.94/theta=0.3: 170x)")
    dense = hw.dense_baseline(hw.SPARTUS, hw.TEST_LAYER)
    fast = hw.evaluate(hw.SPARTUS, hw.TEST_LAYER, 0.9375,
                       sp["temporal_sparsity"], 0.75)
    print(f"   modelled Spartus: dense {dense.latency_us:.1f} us -> "
          f"spatio-temporal {fast.latency_us:.2f} us "
          f"({dense.latency_us / fast.latency_us:.0f}x speedup, "
          f"{fast.batch1_throughput_gops/1e3:.2f} TOp/s effective)")
    return {"pretrain_loss": pre.final_loss, "retrain_loss": post.final_loss,
            "weight_sparsity": ws, "per": per, "frames": logits.shape[0],
            "temporal_sparsity": sp["temporal_sparsity"],
            "op_saving": saving}


if __name__ == "__main__":
    main()
