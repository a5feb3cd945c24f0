"""Port parity, the synthetic speech data: repro_torch.data.speech keeps
the JAX package's config fields, shapes, dtypes, length law, masking and
label convention.  Its random stream is a torch.Generator, so the draws
themselves differ from the reference's; the tests hold the structure,
not the values.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import speech as jspeech
from repro_torch.data import speech as tspeech


def test_config_matches_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jspeech.SpeechConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tspeech.SpeechConfig)]
    assert tf == jf
    cfg = tspeech.SpeechConfig()
    assert (cfg.feat_dim, cfg.vocab) == (123, 41)
    jcfg = jspeech.SpeechConfig()
    assert (cfg.feat_dim, cfg.vocab) == (jcfg.feat_dim, jcfg.vocab)


@pytest.mark.parametrize("max_frames,batch", [(64, 5), (17, 3)])
def test_batch_structure_matches_reference(max_frames, batch):
    tcfg = tspeech.SpeechConfig(max_frames=max_frames)
    jcfg = jspeech.SpeechConfig(max_frames=max_frames)
    port = next(tspeech.SpeechDataset(tcfg, batch))
    ref = jax.device_get(next(jspeech.SpeechDataset(jcfg, batch)))
    for t, j in zip(port, ref):
        assert tuple(t.shape) == tuple(np.shape(j))
        assert str(t.dtype).split(".")[-1] == str(np.asarray(j).dtype)
    feats, n_frames, labels, n_labels = (t.numpy() for t in port)
    f = tcfg.n_static
    for b in range(batch):
        n = int(n_frames[b])
        assert max_frames // 2 <= n <= max_frames
        assert np.all(feats[b, n:] == 0) and np.any(feats[b, :n] != 0)
        # deltas are first differences with the first frame prepended
        np.testing.assert_allclose(
            feats[b, 1:n, f:2 * f],
            feats[b, 1:n, :f] - feats[b, :n - 1, :f], atol=1e-5)
        assert np.all(feats[b, 0, f:] == 0)
        k = int(n_labels[b])
        assert 1 <= k <= n
        assert np.all((labels[b, :k] >= 1) & (labels[b, :k] <= tcfg.n_classes))
        assert np.all(labels[b, k:] == 0)


def test_stream_is_deterministic_and_resumable():
    cfg = tspeech.SpeechConfig(max_frames=32, seed=4)
    a, b = tspeech.SpeechDataset(cfg, 2), tspeech.SpeechDataset(cfg, 2)
    first = next(a)
    assert all(torch.equal(x, y) for x, y in zip(first, next(b)))
    second = next(a)
    assert not torch.equal(first[0], second[0])
    resumed = tspeech.SpeechDataset(cfg, 2)
    resumed.load_state_dict({"step": 1})
    assert all(torch.equal(x, y) for x, y in zip(second, next(resumed)))
    assert a.state_dict() == {"step": 2}
    other = next(tspeech.SpeechDataset(cfg, 2, process_index=1))
    assert not torch.equal(first[0], other[0])
    assert torch.equal(tspeech.class_means(cfg), tspeech.class_means(cfg))
