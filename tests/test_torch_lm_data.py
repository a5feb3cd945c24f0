"""Port parity of the synthetic LM stream (``repro_torch.data.lm``) on the
CPU.  ``jax.random`` draws cannot be regenerated in torch, so the stream
is held against the reference by distribution, not by value:

- ``_zipf_logits`` within 1 float32 ulp of the reference's (at most
  1.2e-7 relative: XLA's float32 ``log`` misses the rounded value by up
  to 1 ulp, so 1e-7 cannot hold on every element);
- with the reference's bigram table carried across as numpy, the port's
  first tokens and (previous, next) transitions against the exact
  categorical laws (``softmax(zipf)`` and ``softmax(zipf + table[prev %
  256])``): Pearson chi-square under its 1 - 1e-4 quantile, cells
  expecting fewer than 5 draws pooled per row; the reference's own draws
  pass the same test;
- the port's own bigram table has the reference's Gumbel(0, 2) moments;
- ``tokens[:, 1:] == targets[:, :-1]``, int32 ids under the vocab;
- the same batch after ``load_state_dict``, and a stream that depends on
  the process index.
"""
import jax
import numpy as np
import torch
from scipy import stats

from repro.data import lm as jlm
from repro_torch.data import lm as tlm

VOCAB, SEQ, N_SEQ = 64, 8, 4096
P_FAIL = 1e-4


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _chi2(observed, expected):
    """(Pearson statistic, degrees of freedom) of one row of counts
    against its expected counts, the cells expecting < 5 pooled."""
    small = expected < 5
    obs = np.append(observed[~small], observed[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(exp) - 1


def _check_law(streams, cfg, table):
    """Chi-square of first tokens and of transitions of ``streams``
    ([N, S+1] ids) against the categorical laws; returns the statistics."""
    base = np.asarray(jlm._zipf_logits(cfg), np.float64)
    first = np.bincount(streams[:, 0], minlength=cfg.vocab)
    stat, dof = _chi2(first, len(streams) * _softmax(base))
    out = {"first": (stat, dof)}
    assert stat <= stats.chi2.ppf(1 - P_FAIL, dof), ("first", stat, dof)
    prev, nxt = streams[:, :-1].ravel(), streams[:, 1:].ravel()
    law = _softmax(base + np.asarray(table, np.float64)[
        np.arange(cfg.vocab) % cfg.markov_states])          # [V, V]
    total, dofs = 0.0, 0
    for s in np.unique(prev):
        sel = prev == s
        st, df = _chi2(np.bincount(nxt[sel], minlength=cfg.vocab),
                       sel.sum() * law[s])
        total, dofs = total + st, dofs + df
    out["transitions"] = (total, dofs)
    assert total <= stats.chi2.ppf(1 - P_FAIL, dofs), ("transitions", total,
                                                      dofs)
    return out


def test_zipf_logits_match_reference():
    for vocab in (64, 32000, 151936):
        cfg = tlm.LMConfig(vocab=vocab)
        want = np.asarray(jlm._zipf_logits(jlm.LMConfig(vocab=vocab)))
        got = tlm._zipf_logits(cfg, "cpu").numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_stream_follows_the_references_law_on_its_table():
    jcfg = jlm.LMConfig(vocab=VOCAB, seq_len=SEQ)
    table = np.asarray(jlm._bigram_table(jcfg))
    cfg = tlm.LMConfig(vocab=VOCAB, seq_len=SEQ)
    gen = torch.Generator().manual_seed(3)
    got = tlm.sample_tokens(gen, cfg, N_SEQ,
                            tlm.bigram_table_from_numpy(table, "cpu"))
    assert got.shape == (N_SEQ, SEQ + 1) and got.dtype == torch.int32
    port = _check_law(got.numpy().astype(np.int64), jcfg, table)
    ref = np.asarray(jlm.sample_tokens(jax.random.key(3), jcfg, N_SEQ))
    want = _check_law(ref.astype(np.int64), jcfg, table)
    assert port["transitions"][1] > 100 and want["first"][1] > 5


def test_port_table_has_the_references_moments():
    cfg = tlm.LMConfig(vocab=VOCAB)
    got = tlm._bigram_table(cfg, "cpu").numpy().astype(np.float64)
    want = np.asarray(jlm._bigram_table(jlm.LMConfig(vocab=VOCAB)),
                      np.float64)
    assert got.shape == want.shape == (cfg.markov_states, VOCAB)
    # Gumbel(0, beta=2): mean 2 * 0.5772, std 2 * pi / sqrt(6); the
    # sample means of 16384 draws sit within 5 standard errors of it
    mean, std = 2 * np.euler_gamma, 2 * np.pi / np.sqrt(6)
    se = std / np.sqrt(got.size)
    for t in (got, want):
        assert abs(t.mean() - mean) <= 5 * se
        assert abs(t.std() - std) <= 0.05 * std
    assert torch.equal(tlm._bigram_table(cfg, "cpu"),
                       tlm._bigram_table(cfg, "cpu"))


def test_dataset_views_and_resume():
    cfg = tlm.LMConfig(vocab=512, seq_len=32)
    data = tlm.LMDataset(cfg, 4, device="cpu")
    batches = [next(data) for _ in range(4)]
    for tok, tgt in batches:
        assert tok.shape == tgt.shape == (4, 32)
        assert tok.dtype == tgt.dtype == torch.int32
        assert torch.equal(tok[:, 1:], tgt[:, :-1])
        assert int(tok.min()) >= 0 and int(tgt.max()) < cfg.vocab
    assert not torch.equal(batches[0][0], batches[1][0])
    assert data.state_dict() == {"step": 4}
    again = tlm.LMDataset(cfg, 4, device="cpu")
    again.load_state_dict({"step": 2})
    for want in batches[2:]:
        got = next(again)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    other = tlm.LMDataset(cfg, 4, process_index=1, device="cpu")
    assert not torch.equal(next(other)[0], batches[0][0])
    started = tlm.LMDataset(cfg, 4, start_step=3, device="cpu")
    assert torch.equal(next(started)[0], batches[3][0])


def test_dataset_takes_a_carried_table():
    """A table given to the dataset is the one it samples from: a table
    that makes one token certain after every state yields only it."""
    cfg = tlm.LMConfig(vocab=16, seq_len=8)
    table = np.full((cfg.markov_states, cfg.vocab), -1e4, np.float32)
    table[:, 5] = 1e4
    data = tlm.LMDataset(cfg, 3, device="cpu",
                         table=tlm.bigram_table_from_numpy(table, "cpu"))
    tok, tgt = next(data)
    assert bool((tgt == 5).all()) and bool((tok[:, 1:] == 5).all())


def test_seed_for_is_a_stable_64_bit_hash():
    words = [(11, 0, 0), (11, 0, 1), (11, 1, 0), (18, 3, 7)]
    seeds = [tlm.seed_for(*w) for w in words]
    assert seeds == [tlm.seed_for(*w) for w in words]
    assert len(set(seeds)) == len(words)
    for s in seeds:
        assert 0 <= s < 2**64
        torch.Generator().manual_seed(s)
