"""Connectionist Temporal Classification loss (Sec. V-B); port of
``repro/training/ctc.py``.

The standard log-space forward algorithm over the blank-extended label
sequence.  The reference scans one sequence over time and vmaps it over
the batch; here the batch is a tensor dimension and time a Python loop.
Padded logits and labels are handled through explicit lengths.

``NEG_INF`` is finite on purpose: with ``-inf``, a logsumexp over three
impossible states has a NaN gradient.  For the same reason the freeze
past ``logit_len`` and the ``label_len == 0`` cases are ``torch.where``
selections, never Python branches.

Also the greedy decoder + edit distance of the paper's PER metric
(greedy best-path decoding, Sec. V-B).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, L] -> blank-interleaved [B, 2L+1]: (b, l1, b, l2, ..., b)."""
    b, l = labels.shape
    ext = torch.full((b, 2 * l + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _shift(alpha: torch.Tensor, k: int) -> torch.Tensor:
    """alpha[:, s - k], NEG_INF for s < k."""
    return torch.nn.functional.pad(alpha[:, :-k], (k, 0), value=NEG_INF)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             logit_lens: torch.Tensor, label_lens: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Mean per-sequence negative log likelihood.

    logits [B, T, V], labels [B, L] int (padded with anything in range),
    logit_lens [B], label_lens [B]."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    t_max = log_probs.shape[1]
    labels = labels.long()
    logit_lens = logit_lens.long()
    label_lens = label_lens.long()
    ext = _extend_labels(labels, blank)                        # [B, S]
    # which extended positions may copy from s-2 (skip a blank): label
    # positions whose label differs from the previous label position
    can_skip = (ext != blank) & (ext != torch.roll(ext, 2, dims=1))
    can_skip[:, :2] = False

    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=logits.device)
    emit0 = log_probs[:, 0].gather(1, ext)
    alpha = torch.full_like(emit0, NEG_INF)
    alpha[:, 0] = emit0[:, 0]
    alpha[:, 1] = torch.where(label_lens > 0, emit0[:, 1], neg)
    for t in range(1, t_max):
        emit = log_probs[:, t].gather(1, ext)
        a_prev2 = torch.where(can_skip, _shift(alpha, 2), neg)
        new = torch.logsumexp(
            torch.stack([alpha, _shift(alpha, 1), a_prev2]), dim=0) + emit
        # freeze past the true sequence length (padding frames)
        alpha = torch.where((t < logit_lens)[:, None], new, alpha)

    end = (2 * label_lens)[:, None]                            # final blank
    last_label = torch.where(label_lens > 0, end[:, 0] - 1, 0)[:, None]
    ll = torch.logaddexp(
        alpha.gather(1, end)[:, 0],
        torch.where(label_lens > 0, alpha.gather(1, last_label)[:, 0], neg))
    return (-ll).mean()


def ctc_loss_brute_force(log_probs: np.ndarray, labels: np.ndarray,
                         blank: int = 0) -> float:
    """Enumerate every alignment — O(V^T); oracle for tiny test cases."""
    t, v = log_probs.shape
    total = NEG_INF

    def collapse(path):
        out, prev = [], None
        for p in path:
            if p != prev and p != blank:
                out.append(p)
            prev = p
        return out

    for path in itertools.product(range(v), repeat=t):
        if collapse(path) == list(labels):
            lp = sum(log_probs[i, p] for i, p in enumerate(path))
            total = np.logaddexp(total, lp)
    return -float(total)


def greedy_decode(logits: torch.Tensor, logit_lens, blank: int = 0):
    """Best-path decoding (paper: 'simple greedy decoder').  Returns a
    python list of label lists (host-side)."""
    best = torch.argmax(logits, dim=-1).cpu().numpy()
    lens = torch.as_tensor(logit_lens).cpu().numpy()
    out = []
    for b in range(best.shape[0]):
        seq, prev = [], None
        for tt in range(int(lens[b])):
            p = int(best[b, tt])
            if p != prev and p != blank:
                seq.append(p)
            prev = p
        out.append(seq)
    return out


def edit_distance(a, b) -> int:
    """Levenshtein distance (for PER: sub+ins+del / len(ref))."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def phone_error_rate(hyps, refs) -> float:
    """PER = total edit distance / total reference length."""
    dist = sum(edit_distance(h, r) for h, r in zip(hyps, refs))
    total = sum(len(r) for r in refs)
    return dist / max(total, 1)
