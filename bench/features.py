"""Speech-like frames, a frozen and vectorised copy of the port's
``data/speech.py`` law (its draws are not reproduced, its statistics
are):

* piecewise-stationary "phoneme" segments: a new segment starts at each
  frame with probability ``1 / avg_segment``, its class uniform over
  ``n_classes``, each class a fixed target vector ``N(0, mean_scale^2)``;
* Ornstein-Uhlenbeck dynamics toward the segment's target,
  ``x_t = tau x_{t-1} + (1 - tau) target_t + noise sqrt(1 - tau^2) eps``;
* ``n_static`` static features plus their first and second temporal
  differences (``3 n_static`` = 123 for TIMIT's layout).

Temporal smoothness is what makes a delta network's deltas sparse, so a
mix states its features.  ``kind: "noise"`` is white noise of the given
scale instead (nearly every delta fires).
"""
from __future__ import annotations

from typing import List

import numpy as np


def make(spec: dict, lengths: np.ndarray, dim: int,
         rng: np.random.Generator) -> List[np.ndarray]:
    kind = spec["kind"]
    if kind == "noise":
        return [rng.standard_normal((int(t), dim), dtype=np.float32)
                * np.float32(spec["scale"]) for t in lengths]
    if kind != "speech":
        raise ValueError(f"unknown feature kind {kind!r}")
    return speech(spec, lengths, dim, rng)


def speech(spec: dict, lengths: np.ndarray, dim: int,
           rng: np.random.Generator) -> List[np.ndarray]:
    f = spec["n_static"]
    if dim != 3 * f:
        raise ValueError(f"{f} static features make {3 * f} dims, the "
                         f"model takes {dim}")
    lengths = np.asarray(lengths, np.int64)
    n, t_max = len(lengths), int(np.max(lengths))
    tau, noise = np.float32(spec["tau"]), np.float32(spec["noise"])
    gain = np.float32(np.sqrt(1.0 - float(tau) ** 2))
    means = (rng.standard_normal((spec["n_classes"], f), dtype=np.float32)
             * np.float32(spec["mean_scale"]))
    # time-major, utterances longest first: at frame i only the first
    # n_live[i] utterances are still running
    by_len = np.argsort(-lengths, kind="stable")
    n_live = (lengths[by_len][None, :] > np.arange(t_max)[:, None]).sum(1)
    change = rng.random((t_max, n)) < 1.0 / spec["avg_segment"]
    change[0] = True
    seg_id = np.cumsum(change, axis=0) - 1
    seg_class = rng.integers(0, spec["n_classes"], (t_max, n))
    frame_class = np.take_along_axis(seg_class, seg_id, axis=0)
    traj = np.zeros((t_max, n, f), np.float32)
    x = means[frame_class[0]]
    for i in range(t_max):
        k = n_live[i]
        eps = rng.standard_normal((k, f), dtype=np.float32) * (noise * gain)
        x = tau * x[:k] + (1 - tau) * means[frame_class[i, :k]] + eps
        traj[i, :k] = x
    d1 = np.diff(traj, axis=0, prepend=traj[:1])
    d2 = np.diff(d1, axis=0, prepend=d1[:1])
    full = np.concatenate([traj, d1, d2], axis=-1)        # [T, N, 3F]
    out: List[np.ndarray] = [None] * n
    for j, i in enumerate(by_len):
        out[i] = np.ascontiguousarray(full[:lengths[i], j])
    return out
