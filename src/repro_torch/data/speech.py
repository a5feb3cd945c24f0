"""Synthetic speech-feature pipeline (offline stand-in for TIMIT) — port
of ``repro/data/speech.py``.

Sequences with the statistical properties the paper's mechanism depends
on:

  * piecewise-stationary "phoneme" segments (geometric durations),
  * slowly-varying (Ornstein-Uhlenbeck) intra-segment feature dynamics,
    whose smoothness ``tau`` is what gives delta networks their sparsity,
  * 123-dim features mirroring TIMIT's: 41 static (40 Mel-like + energy)
    plus first and second temporal derivatives (Sec. V-B),
  * CTC phoneme targets = the segment class sequence (blank = 0).

Same config fields, shapes, dtypes, length law (uniform in [T/2, T]),
masking and label convention as the reference.  The random stream is a
``torch.Generator`` seeded from (seed, process, step): the reference's
``jax.random`` stream cannot be regenerated here, so the port's features
differ from the reference's draw for draw.  Everything is made on the
host, in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpeechConfig:
    n_classes: int = 40          # phoneme inventory (excl. blank)
    n_static: int = 41           # 40 Mel-like + energy
    avg_segment: int = 8         # mean phoneme duration (frames)
    tau: float = 0.9             # OU smoothness (higher = smoother = sparser deltas)
    noise: float = 0.15          # observation noise
    max_frames: int = 128
    seed: int = 0

    @property
    def feat_dim(self) -> int:   # static + delta + delta-delta
        return 3 * self.n_static

    @property
    def vocab(self) -> int:      # CTC classes: blank(0) + phonemes
        return self.n_classes + 1


def _generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative ints."""
    seed = 0
    for k in keys:
        seed = (seed * 1_000_003 + int(k) + 1) % (1 << 62)
    return torch.Generator().manual_seed(seed)


def class_means(cfg: SpeechConfig) -> torch.Tensor:
    """Fixed per-class target vectors (the dataset's 'formant' table)."""
    gen = _generator(cfg.seed)
    return torch.randn((cfg.n_classes, cfg.n_static), generator=gen) * 1.5


def _derivatives(x: torch.Tensor) -> torch.Tensor:
    """First/second temporal derivative features, concatenated. x: [T, F]."""
    d1 = torch.diff(x, dim=0, prepend=x[:1])
    d2 = torch.diff(d1, dim=0, prepend=d1[:1])
    return torch.cat([x, d1, d2], dim=-1)


def synth_utterance(
    gen: torch.Generator, cfg: SpeechConfig, means: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One utterance: (features [T, 3F] float32, n_frames int32,
    labels [T] int32, n_labels int32).

    labels is padded to T; blank id is 0, so phoneme classes are 1..N."""
    t = cfg.max_frames
    # segment boundaries: bernoulli changes, forced at t=0
    change = torch.rand((t,), generator=gen) < 1.0 / cfg.avg_segment
    change[0] = True
    seg_id = torch.cumsum(change.to(torch.int64), 0) - 1
    seg_class = torch.randint(0, cfg.n_classes, (t,), generator=gen)
    frame_class = seg_class[seg_id]                               # [T]
    # utterance length: uniform in [T/2, T]
    n_frames = torch.randint(t // 2, t + 1, (), generator=gen)
    # OU trajectory toward the active class mean
    target = means[frame_class]                                   # [T, F]
    eps = torch.randn((t, cfg.n_static), generator=gen) * cfg.noise
    gain = (1.0 - cfg.tau ** 2) ** 0.5
    traj = torch.empty_like(target)
    x = target[0]
    for i in range(t):
        x = cfg.tau * x + (1.0 - cfg.tau) * target[i] + eps[i] * gain
        traj[i] = x
    frames = torch.arange(t)
    feats = _derivatives(traj) * (frames < n_frames)[:, None]
    # labels: class of each segment that starts within n_frames
    starts = change & (frames < n_frames)
    n_labels = starts.sum().to(torch.int32)
    order = torch.argsort((~starts).to(torch.int8), stable=True)
    labels = torch.where(frames < n_labels, frame_class[order] + 1, 0)
    return (feats.to(torch.float32), n_frames.to(torch.int32),
            labels.to(torch.int32), n_labels)


def make_batch(gen: torch.Generator, cfg: SpeechConfig, batch: int,
               means: torch.Tensor):
    """(feats [B,T,3F], feat_lens [B], labels [B,T], label_lens [B])."""
    utts = [synth_utterance(gen, cfg, means) for _ in range(batch)]
    return tuple(torch.stack(parts) for parts in zip(*utts))


class SpeechDataset:
    """Sharded, stateful iterator.  Each (process, step) pair seeds its
    own generator, so restarts resume exactly from the checkpointed step
    and every process reads disjoint data with no communication."""

    def __init__(self, cfg: SpeechConfig, batch_per_host: int,
                 process_index: int = 0, start_step: int = 0):
        self.cfg = cfg
        self.batch = batch_per_host
        self.process_index = process_index
        self.step = start_step
        self.means = class_means(cfg)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        gen = _generator(self.cfg.seed + 1, self.process_index, self.step)
        out = make_batch(gen, self.cfg, self.batch, self.means)
        self.step += 1
        return out

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])
