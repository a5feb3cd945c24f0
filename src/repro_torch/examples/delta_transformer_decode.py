"""Beyond-paper example: the delta-network idea applied to a
transformer's time-distributed projections (DeltaLinear, eq. 2
generalised) — port of ``examples/delta_transformer_decode.py``.

Measures how much temporal sparsity DeltaLinear extracts from smooth
speech-frame embeddings at several thresholds, versus the same mechanism
on text-token embeddings (where smoothness, and hence sparsity, is
absent): delta sparsity is a property of the *signal*, and speech-like
inputs are where it pays.  (The reference imports its architecture
registry and model API without using them; this needs only DeltaLinear
and the synthetic speech data.)

    python -m repro_torch.examples.delta_transformer_decode [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.core.delta_linear import delta_linear_over_time
from repro_torch.data.speech import SpeechConfig, class_means, synth_utterance

THETAS = [0.0, 0.05, 0.1, 0.3]


def smooth_frames(t: int = 96, d: int = 128) -> torch.Tensor:
    cfg = SpeechConfig(max_frames=t, n_static=d // 3 + 1, tau=0.95)
    feats, *_ = synth_utterance(torch.Generator().manual_seed(0), cfg,
                                class_means(cfg))
    return feats[:, :d] / (feats[:, :d].std() + 1e-6)


def token_embeds(t: int = 96, d: int = 128) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    emb = torch.randn((512, d), generator=gen) * (1 / d ** 0.5)
    toks = torch.randint(0, 512, (t,), generator=gen)
    x = emb[toks]
    return x / (x.std() + 1e-6)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--out-dim", type=int, default=256)
    args = ap.parse_args(argv)

    d, o, dev = args.dim, args.out_dim, torch.device(args.device)
    w = (torch.randn((o, d), generator=torch.Generator().manual_seed(3))
         / d ** 0.5).to(dev)
    speech = smooth_frames(args.frames, d).to(dev)
    text = token_embeds(args.frames, d).to(dev)

    rows = []
    print(f"{'theta':>6} | {'speech ts':>9} | {'text ts':>8} | max |err|")
    for theta in THETAS:
        ys, _, aux_s = delta_linear_over_time(w, speech, theta)
        _, _, aux_t = delta_linear_over_time(w, text, theta)
        ts_s = 1.0 - float(aux_s["nnz_dx"].float().mean()) / d
        ts_t = 1.0 - float(aux_t["nnz_dx"].float().mean()) / d
        err = float((ys - speech @ w.T).abs().max())
        print(f"{theta:6.2f} | {ts_s:9.1%} | {ts_t:8.1%} | {err:.3f}")
        rows.append({"theta": theta, "speech_ts": ts_s, "text_ts": ts_t,
                     "max_err": err})

    print("\nSmooth (speech-like) inputs give high delta sparsity; token "
          "embeddings give ~0 beyond the threshold floor, matching the "
          "paper's premise.")
    return rows


if __name__ == "__main__":
    main()
