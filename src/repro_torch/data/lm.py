"""Synthetic LM token pipeline for the zoo's transformer architectures;
port of ``repro/data/lm.py``.

Zipf-distributed unigrams mixed with a first-order Markov back-off so the
streams are learnable, with no disk.  Deterministic in (seed, process,
step), drawn on the device from explicit ``torch.Generator``s.

The reference keys each batch with ``fold_in(fold_in(key(seed + 11),
process), step)``; ``jax.random`` streams cannot be regenerated in torch,
so the port seeds one generator per batch from ``seed_for(seed + 11,
process, step)``: numpy's ``SeedSequence`` hash of the three words, which
is stable across runs, processes and machines.  The law is the
reference's (Gumbel-max categorical draws, the same logits); the draws
are not.  ``bigram_table_from_numpy`` takes the reference's table as it
is, so the two can be held against one table by distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, upload


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int = 32000
    seq_len: int = 1024
    zipf_a: float = 1.1
    markov_states: int = 256   # size of the hidden bigram table
    seed: int = 0


def seed_for(*words: int) -> int:
    """A 64-bit generator seed hashed from ``words`` (``SeedSequence``)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def _zipf_logits(cfg: LMConfig, device: DeviceLike = None) -> torch.Tensor:
    """``-zipf_a * log(rank)``, computed in float64 and rounded once: the
    float32 ``log`` of XLA and of torch each miss the rounded value by up
    to 1-2 ulp, so this keeps the port within 1 ulp of the reference."""
    ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64,
                         device=resolve_device(device))
    return (-cfg.zipf_a * torch.log(ranks)).to(torch.float32)


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise as ``jax.random.gumbel`` draws it:
    ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def _bigram_table(cfg: LMConfig, device: DeviceLike = None) -> torch.Tensor:
    """[markov_states, vocab] logits; tokens hash into markov states."""
    gen = torch.Generator(resolve_device(device)).manual_seed(cfg.seed + 7)
    return _gumbel(gen, (cfg.markov_states, cfg.vocab)) * 2.0


def bigram_table_from_numpy(table: np.ndarray,
                            device: DeviceLike = None) -> torch.Tensor:
    """The reference's ``_bigram_table`` output, carried across as numpy."""
    return upload(np.asarray(table, np.float32), resolve_device(device))


def sample_tokens(gen: torch.Generator, cfg: LMConfig, batch: int,
                  table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S+1] int32 token streams on the generator's device (callers
    slice input/target views).  Each token is a Gumbel-max draw from
    ``zipf + table[prev % markov_states]``, the first from ``zipf``."""
    dev = gen.device
    base = _zipf_logits(cfg, dev)
    if table is None:
        table = _bigram_table(cfg, dev)
    tok = torch.argmax(base + _gumbel(gen, (batch, cfg.vocab)), dim=-1)
    toks = [tok]
    for _ in range(cfg.seq_len):
        logits = base + table[tok % cfg.markov_states]
        tok = torch.argmax(logits + _gumbel(gen, logits.shape), dim=-1)
        toks.append(tok)
    return torch.stack(toks, 1).to(torch.int32)


class LMDataset:
    """Sharded iterator yielding (tokens [B,S], targets [B,S]) on
    ``device`` (``cuda`` by default).  ``table`` replaces the bigram table
    (``bigram_table_from_numpy``); by default it is drawn on the device at
    the first batch."""

    def __init__(self, cfg: LMConfig, batch_per_host: int,
                 process_index: int = 0, start_step: int = 0,
                 device: DeviceLike = None,
                 table: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.batch = batch_per_host
        self.process_index = process_index
        self.step = start_step
        self.device = resolve_device(device)
        self._table = table

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._table is None:
            self._table = _bigram_table(self.cfg, self.device)
        gen = torch.Generator(self.device).manual_seed(
            seed_for(self.cfg.seed + 11, self.process_index, self.step))
        self.step += 1
        stream = sample_tokens(gen, self.cfg, self.batch, self._table)
        return stream[:, :-1], stream[:, 1:]

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])
