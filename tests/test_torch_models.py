"""Port parity, the model zoo's serving path: ``repro_torch.models`` against
the reference on the CPU, for all 10 registry architectures at
``.reduced()`` widths.  Reference params come from
``repro.models.api.init_params(cfg, jax.random.key(0))`` and reach the
port through ``api.params_from_numpy``; inputs are seeded numpy.

- the full-sequence forward over S=32 (``forward``; for the audio
  family ``decode_train`` on ``encode``);
- ``prefill``, plain and with ``q_chunk=8`` (the q-chunk loop, and for
  recurrentgemma the windowed kv slab);
- 8 ``serve_step``s from a zero cache (audio: against ``prefill``'s
  cross-KV), each step's logits, and ``pos`` advancing as a 0-d int32
  tensor.

Tolerance: |port - reference| <= 1e-5 * max|reference| + 1e-6 (fp32
sums in another order; the RG-LRU scan groups its products in another
order than ``associative_scan`` and stays inside the same bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import mamba2 as jmamba2
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttransformer
from torch_zoo_parity import (
    ARCHS,
    assert_close,
    both_params,
    configs,
    seq_inputs,
    step_inputs,
    t,
)

SEQ = 32
ENC_LEN = 12


def _forward(mods, params, cfg, x, toks):
    transformer, mamba2, rglru, encdec = mods
    if cfg.family in ("dense", "moe"):
        return transformer.forward(params, cfg, x)
    if cfg.family == "vlm":
        return transformer.forward(params, cfg, None, inputs_embeds=x)
    if cfg.family == "ssm":
        return mamba2.forward(params, cfg, x)
    if cfg.family == "hybrid":
        return rglru.forward(params, cfg, x)
    return encdec.decode_train(params, cfg, toks, encdec.encode(params, cfg, x))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_reference(name):
    jcfg, tcfg = configs(name)
    jp, tp = both_params(name)
    x = seq_inputs(jcfg, 2, SEQ, seed=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8)).astype(
        np.int32)
    want = _forward((jtransformer, jmamba2, jrglru, jencdec), jp, jcfg,
                    jnp.asarray(x), jnp.asarray(toks))
    got = _forward((ttransformer, tmamba2, trglru, tencdec), tp, tcfg, t(x),
                   t(toks))
    assert got.shape[-1] == tcfg.vocab
    assert_close(got, want, f"{name} forward")


@pytest.mark.parametrize("q_chunk", [0, 8], ids=["plain", "q_chunk8"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, q_chunk):
    jcfg, tcfg = configs(name)
    jp, tp = both_params(name)
    x = seq_inputs(jcfg, 2, SEQ, seed=3)
    want = japi.prefill(jp, jcfg, jnp.asarray(x), q_chunk=q_chunk)
    got = tapi.prefill(tp, tcfg, t(x), q_chunk=q_chunk)
    if jcfg.family == "audio":                   # the cross-KV per layer
        for kv in ("k", "v"):
            assert_close(got[kv], want[kv], f"{name} prefill cross {kv}")
    else:
        assert got.shape == (2, 1, tcfg.vocab)
        assert_close(got, want, f"{name} prefill")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_steps_match_reference(name):
    jcfg, tcfg = configs(name)
    jp, tp = both_params(name)
    jcache = japi.init_cache(jcfg, 2, 16 if jcfg.family != "audio" else ENC_LEN)
    tcache = tapi.init_cache(tcfg, 2, 16 if tcfg.family != "audio" else ENC_LEN,
                             device="cpu")
    if jcfg.family == "audio":
        frames = seq_inputs(jcfg, 2, ENC_LEN, seed=4)
        jcache["cross"] = japi.prefill(jp, jcfg, jnp.asarray(frames))
        tcache["cross"] = tapi.prefill(tp, tcfg, t(frames))
    for i, inp in enumerate(step_inputs(jcfg, 2, 8, seed=5)):
        want, jcache = japi.serve_step(jp, jcfg, jnp.asarray(inp), jcache)
        got, tcache = tapi.serve_step(tp, tcfg, t(inp), tcache)
        assert got.shape == (2, 1, tcfg.vocab)
        assert_close(got, want, f"{name} step {i}")
    pos = tcache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int32 and int(pos) == 8
    assert int(jcache["pos"]) == 8
