"""Port parity, core numerics: repro_torch.core / models / configs against
the JAX reference on the same numpy inputs.

Bit-equal where the reference is exact (quantization grids with .5 ties,
CBCSC arrays under raise and clip, CBTD masks with magnitude ties);
1e-5 for the recurrent float paths (same math, another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import spartus_lstm as jconfigs
from repro.models import lstm_am as jam
from repro_torch import core as tcore
from repro_torch.configs import spartus_lstm as tconfigs
from repro_torch.models import lstm_am as tam


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- quantization --------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("amp", [1e-3, 0.37, 5.0, 127.0])
def test_pow2_scale_and_quantize_bit_equal(bits, amp):
    w = (np.random.default_rng(bits).standard_normal((64, 48)) * amp
         ).astype(np.float32)
    _eq(jcore.quantization.pow2_scale_for(jnp.asarray(w), bits),
        tcore.pow2_scale_for(_t(w), bits))
    _eq(jcore.quantize(jnp.asarray(w), bits), tcore.quantize(_t(w), bits))


def test_quantize_act_half_to_even_ties():
    """Q8.8 midpoints k/256 + 1/512 round to the even code in both."""
    k = np.arange(-700, 700, dtype=np.float32)
    x = np.concatenate([(k + 0.5) / 256, k / 256 + 1e-4,
                        np.array([200.0, -200.0, 127.998, -128.01],
                                 np.float32)]).astype(np.float32)
    want = np.asarray(jcore.quantize_act(jnp.asarray(x), 16, 8))
    got = tcore.quantize_act(_t(x), 16, 8).numpy()
    np.testing.assert_array_equal(want, got)
    # the ties really are ties, and half of them round down
    q = got[:1400] * 256
    assert np.all(q % 2 == 0)


def test_int8_pack_bit_equal_with_ties():
    scale = np.float32(2.0 ** -7)
    codes = np.arange(-130, 130, dtype=np.float32)
    w = np.concatenate([(codes + 0.5) * scale, codes * scale]).astype(
        np.float32).reshape(20, -1)
    for s in (None, jnp.asarray(scale)):
        jq, js = jcore.int8_pack(jnp.asarray(w), s)
        tq, ts = tcore.int8_pack(_t(w), None if s is None else _t(scale))
        _eq(jq, tq)
        _eq(js, ts)
        assert tq.dtype == torch.int8


def test_quant_config_matches():
    assert (dataclasses.asdict(tcore.QuantConfig())
            == dataclasses.asdict(jcore.QuantConfig()))


# -- CBTD / CBCSC --------------------------------------------------------------


def _tied_matrix(seed, h, q):
    """Values from a small set so magnitude ties are everywhere."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, size=(h, q)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("h,q,m,gamma", [(64, 24, 8, 0.75), (128, 40, 16, 0.9),
                                         (48, 16, 4, 0.5)])
@pytest.mark.parametrize("tied", [False, True])
def test_cbtd_mask_bit_equal(h, q, m, gamma, tied):
    w = (_tied_matrix(h, h, q) if tied else np.random.default_rng(h)
         .standard_normal((h, q)).astype(np.float32))
    _eq(jcore.cbtd_mask(jnp.asarray(w), gamma, m),
        tcore.cbtd_mask(_t(w), gamma, m))
    _eq(jcore.apply_cbtd(jnp.asarray(w), gamma, m),
        tcore.apply_cbtd(_t(w), gamma, m))
    assert tcore.keep_count(h, m, gamma) == jcore.keep_count(h, m, gamma)
    assert tcore.drop_count(h, m, gamma) == jcore.drop_count(h, m, gamma)


@pytest.mark.parametrize("h,q,m,gamma", [(64, 24, 8, 0.75), (128, 40, 16, 0.9)])
@pytest.mark.parametrize("case", ["pruned", "clip", "clip_tied", "lossless"])
def test_cbcsc_encode_decode_bit_equal(h, q, m, gamma, case):
    rng = np.random.default_rng(q)
    if case == "pruned":
        w = np.asarray(jcore.apply_cbtd(
            jnp.asarray(rng.standard_normal((h, q)), jnp.float32), gamma, m))
    elif case == "clip_tied":
        w = _tied_matrix(q, h, q)
    else:
        w = rng.standard_normal((h, q)).astype(np.float32)
    blen = None if case == "lossless" else jcore.blen_for(h, m, gamma)
    assert tcore.blen_for(h, m, gamma) == jcore.blen_for(h, m, gamma)
    je = jcore.cbcsc_encode(jnp.asarray(w), m, blen=blen, on_overflow="clip")
    te = tcore.cbcsc_encode(_t(w), m, blen=blen, on_overflow="clip")
    for a in ("val", "lidx", "valid"):
        _eq(getattr(je, a), getattr(te, a))
    assert (te.h, te.m, te.blen, te.s, te.q) == (je.h, je.m, je.blen, je.s,
                                                 je.q)
    _eq(jcore.cbcsc_decode(je, jnp.float32), tcore.cbcsc_decode(te,
                                                                torch.float32))


def test_cbcsc_raise_on_overflow_in_both():
    w = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="exceeds BLEN"):
        jcore.cbcsc_encode(jnp.asarray(w), 4, blen=2)
    with pytest.raises(ValueError, match="exceeds BLEN"):
        tcore.cbcsc_encode(_t(w), 4, blen=2)
    with pytest.raises(ValueError, match="not divisible"):
        tcore.cbcsc_encode(_t(w), 5)


# -- DeltaLSTM -----------------------------------------------------------------


def _lstm_params(seed, d, h):
    p = jax.device_get(jcore.init_lstm_params(jax.random.key(seed), d, h))
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("theta", [0.0, 0.1, 0.3])
def test_delta_threshold_bit_equal(theta):
    rng = np.random.default_rng(1)
    cur = rng.standard_normal(257).astype(np.float32)
    ref = (cur + rng.standard_normal(257) * 0.2).astype(np.float32)
    jd, jr = jcore.delta_threshold(jnp.asarray(cur), jnp.asarray(ref), theta)
    td, tr = tcore.delta_threshold(_t(cur), _t(ref), theta)
    _eq(jd, td)
    _eq(jr, tr)


@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_delta_lstm_layer_matches_reference(theta):
    jp, tp = _lstm_params(3, 12, 16)
    xs = np.random.default_rng(2).standard_normal((9, 12)).astype(np.float32)
    jhs, jst, jaux = jcore.delta_lstm_layer(jp, jnp.asarray(xs), theta)
    ths, tst, taux = tcore.delta_lstm_layer(tp, _t(xs), theta)
    np.testing.assert_allclose(np.asarray(jhs), ths.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jst.dm), tst.dm.numpy(), atol=1e-5)
    _eq(jaux["nnz_dx"], taux["nnz_dx"])
    _eq(jaux["nnz_dh"], taux["nnz_dh"])
    # batched (leading dim) == per-sequence
    tb, _, _ = tcore.delta_lstm_layer(tp, _t(np.stack([xs, xs[::-1]])), theta)
    np.testing.assert_allclose(tb[0].numpy(), ths.numpy(), atol=1e-6)


def test_lstm_layer_and_stacked_matrix():
    jp, tp = _lstm_params(4, 10, 8)
    xs = np.random.default_rng(5).standard_normal((7, 10)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jcore.lstm_layer(jp, jnp.asarray(xs))),
                               tcore.lstm_layer(tp, _t(xs)).numpy(), atol=1e-5)
    _eq(jcore.stacked_weight_matrix(jp), tcore.stacked_weight_matrix(tp))


def test_init_lstm_params_seeded():
    a = tcore.init_lstm_params(torch.Generator().manual_seed(7), 6, 4)
    b = tcore.init_lstm_params(torch.Generator().manual_seed(7), 6, 4)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["w_x"].shape == (16, 6) and a["w_h"].shape == (16, 4)
    assert float(a["w_x"].abs().max()) <= 0.5
    assert torch.equal(a["b"][2], torch.ones(4))


# -- LSTM acoustic model ------------------------------------------------------

CFG_KW = dict(input_dim=20, hidden_dim=32, n_layers=2, n_classes=11)


@pytest.fixture(scope="module")
def am_params():
    cfg = jam.LSTMAMConfig(**CFG_KW)
    p = jam.init_params(jax.random.key(0), cfg)
    return jax.device_get(p), tam.params_from_numpy(jax.device_get(p),
                                                    device="cpu")


@pytest.mark.parametrize("delta,quant", [(False, False), (True, False),
                                         (True, True)])
def test_forward_matches_reference(am_params, delta, quant):
    jp, tp = am_params
    qkw = dict(quant=jcore.QuantConfig(enabled=quant))
    jcfg = jam.LSTMAMConfig(**CFG_KW, delta=delta, theta=0.05, **qkw)
    tcfg = tam.LSTMAMConfig(**CFG_KW, delta=delta, theta=0.05,
                            quant=tcore.QuantConfig(enabled=quant))
    feats = np.random.default_rng(9).standard_normal((2, 8, 20)).astype(
        np.float32)
    jl, jaux = jam.forward(jp, jcfg, jnp.asarray(feats), collect_aux=delta)
    tl, taux = tam.forward(tp, tcfg, _t(feats), collect_aux=delta)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-5)
    if delta:
        for ja, ta in zip(jaux["layers"], taux["layers"]):
            _eq(ja["nnz_dx"], ta["nnz_dx"])
    assert tcfg.name == jcfg.name


def test_cbtd_prune_stacks_bit_equal(am_params):
    jp, tp = am_params
    jpr = jax.device_get(jam.cbtd_prune_stacks(jp, gamma=0.75, m=4))
    tpr = tam.cbtd_prune_stacks(tp, gamma=0.75, m=4)
    for jl, tl in zip(jpr["lstm"], tpr["lstm"]):
        for k in ("w_x", "w_h", "b"):
            _eq(jl[k], tl[k])
    _eq(jpr["fcl"]["w"], tpr["fcl"]["w"])


def test_params_from_numpy_structure(am_params):
    jp, tp = am_params
    assert isinstance(tp["lstm"], list) and len(tp["lstm"]) == 2
    assert tp["lstm"][0]["w_x"].dtype == torch.float32
    _eq(jp["logit"]["w"], tp["logit"]["w"])


def test_init_params_seeded_on_cpu():
    cfg = tam.LSTMAMConfig(**CFG_KW)
    a = tam.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    b = tam.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert torch.equal(a["lstm"][1]["w_h"], b["lstm"][1]["w_h"])
    assert a["lstm"][0]["w_x"].shape == (128, 20)
    assert a["logit"]["w"].shape == (11, 32)


@pytest.mark.parametrize("name", ["LSTM_3L_512H", "LSTM_2L_768H",
                                  "LSTM_2L_1024H", "DELTA_LSTM_2L_1024H"])
def test_table2_configs_match(name):
    j, t = getattr(jconfigs, name), getattr(tconfigs, name)
    for f in ("input_dim", "hidden_dim", "n_layers", "n_classes", "delta",
              "theta"):
        assert getattr(j, f) == getattr(t, f)
    assert j.name == t.name
