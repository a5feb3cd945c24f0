"""Whether what the clients held is right: a seeded sample of the
finished requests (the longest always among them) against the plain
reference, run once the program is gone.

Two numbers, each with its limit (the configuration file's ``limits``):

* ``logit_gap``: the largest ``|program - reference|`` over every row of
  the sample, over the largest ``|reference|`` logit of the sample;
* ``missing_rows``: over every finished request, rows held but for
  frames that were never sent, or frames sent that have no row (0).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bench.generator import rng_for


def pick(finished: List[Tuple[int, np.ndarray]], n: int,
         seed: int) -> List[int]:
    """Indices into ``finished``: its longest request, and a sample of
    the rest drawn from the seed, ``n`` in all."""
    if not finished:
        return []
    longest = int(np.argmax([rows.shape[0] for _, rows in finished]))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = rng_for(seed, 5)
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(take)]


def reference_logits(ref, params, cfg: dict, feats: List[np.ndarray],
                     device, precision: str = "fp32", block: int = 32
                     ) -> List[np.ndarray]:
    """The reference's logits for each utterance, in blocks of rows;
    ``ref`` is the configuration's reference module
    (``Manifest.reference(cfg["reference"])``)."""
    import torch

    out = []
    for at in range(0, len(feats), block):
        part = feats[at:at + block]
        t_max = max(f.shape[0] for f in part)
        x = np.zeros((len(part), t_max, part[0].shape[1]), np.float32)
        for i, f in enumerate(part):
            x[i, :f.shape[0]] = f
        y = ref.forward(params, cfg, torch.from_numpy(x).to(device),
                        precision).cpu().numpy()
        out += [y[i, :f.shape[0]] for i, f in enumerate(part)]
    return out


def logit_gap(got: List[np.ndarray], want: List[np.ndarray]) -> float:
    scale = max(float(np.abs(w).max()) for w in want)
    gap = max(float(np.abs(g.astype(np.float64) - w).max())
              for g, w in zip(got, want))
    return gap / max(scale, 1e-30)


def check(finished, plan, ref, params, cfg: dict, n_sample: int,
          seed: int, device) -> Dict[str, Dict[str, float]]:
    missing = 0
    for uid, rows in finished:
        missing += abs(plan.feats[uid].shape[0] - rows.shape[0])
    chosen = [finished[i] for i in pick(finished, n_sample, seed)]
    chosen = [(uid, rows) for uid, rows in chosen
              if rows.shape[0] == plan.feats[uid].shape[0]]
    if chosen:
        want = reference_logits(ref, params, cfg,
                                [plan.feats[uid] for uid, _ in chosen],
                                device)
        gap = logit_gap([rows for _, rows in chosen], want)
    else:
        gap = float("inf")
    limits = cfg["limits"]
    return {"logit_gap": {"value": gap, "limit": limits["logit_gap"]},
            "missing_rows": {"value": float(missing), "limit": 0.0}}
