"""Port parity, the core the trainer uses: CBTD at every alpha and both
granularities, ``cbtd_prune_tree`` over the acoustic model's tree, the
sparsity statistics, ``quantize_tree``/``int8_unpack``, the batched
layer names and ``lstm_am.n_params``/``lstm_weight_layout``, against the
JAX reference on the same numpy inputs.

Masks are bit-equal wherever the reference is deterministic (alpha = 1,
magnitude ties included).  The alpha < 1 drops draw from a
``torch.Generator`` where the reference draws from ``jax.random``, so
they are held by their law: none at alpha 0, the deterministic mask at
alpha 1, half the candidates (+-0.05) at alpha 0.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import cbtd as jcbtd
from repro.models import lstm_am as jam
from repro_torch import core as tcore
from repro_torch.core import cbtd as tcbtd
from repro_torch.models import lstm_am as tam


def _np(x):
    return np.asarray(x)


def _weights(seed, shape, ties=False):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:       # quantized magnitudes: many exact ties, both signs
        w = np.round(w * 2) / 2
    return w


@pytest.mark.parametrize("h,q,m,gamma,ties", [
    (64, 24, 4, 0.75, False), (64, 24, 4, 0.75, True),
    (4096, 16, 64, 0.9375, False), (96, 7, 8, 0.5, True),
    (4096, 8, 64, 0.94, False)])
def test_element_mask_alpha_one_bit_equal(h, q, m, gamma, ties):
    w = _weights(h + q, (h, q), ties)
    want = _np(jcore.cbtd_mask(jnp.asarray(w), gamma, m, alpha=1.0))
    got = tcore.cbtd_mask(torch.tensor(w), gamma, m, alpha=1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    # below alpha 1 the deterministic path drops nothing, as the reference
    assert tcore.cbtd_mask(torch.tensor(w), gamma, m, alpha=0.999).all()
    np.testing.assert_array_equal(
        tcore.apply_cbtd(torch.tensor(w), gamma, m).numpy(),
        _np(jcore.apply_cbtd(jnp.asarray(w), gamma, m)))


@pytest.mark.parametrize("shape,gamma,tile", [
    ((64, 512), 0.75, (8, 128)), ((32, 256), 0.5, (8, 128)),
    ((48, 64), 0.7, (4, 16))])
def test_tile_mask_alpha_one_bit_equal(shape, gamma, tile):
    w = _weights(shape[0], shape)
    want = _np(jcore.cbtd_tile_mask(jnp.asarray(w), gamma, tile, alpha=1.0))
    got = tcore.cbtd_tile_mask(torch.tensor(w), gamma, tile, alpha=1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = tcbtd.CBTDConfig(gamma=gamma, granularity="tile", tile=tile)
    np.testing.assert_array_equal(cfg.mask_fn(torch.tensor(w)).numpy(), want)


@pytest.mark.parametrize("granularity", ["element", "tile"])
def test_generator_drops_follow_the_law(granularity):
    """alpha 0 drops nothing, alpha 1 is the deterministic mask, alpha 0.5
    drops half the candidates (+-0.05), always a subset of them."""
    w = torch.tensor(_weights(3, (256, 512)))
    cfg = tcbtd.CBTDConfig(gamma=0.75, m=8, granularity=granularity,
                           tile=(4, 8))
    gen = torch.Generator().manual_seed(11)
    full = cfg.mask_fn(w, 1.0)
    assert cfg.mask_fn(w, 0.0, gen).all()
    assert torch.equal(cfg.mask_fn(w, 1.0, gen), full)
    half = cfg.mask_fn(w, 0.5, gen)
    assert not (~half & full).any()            # drops only candidates
    share = float((~half).sum()) / float((~full).sum())
    assert share == pytest.approx(0.5, abs=0.05)


def test_alpha_schedule_and_effective_m_equal():
    for epoch in (0, 1, 2, 15, 29, 30, 31, 100):
        for da in (1 / 30, 0.5, 1.0, 0.3):
            assert tcore.alpha_at(epoch, da) == float(jcore.alpha_at(epoch, da))
    for h, m in ((4096, 64), (3352, 64), (96, 64), (7, 8), (1, 4)):
        assert tcbtd.effective_m(h, m) == jcbtd.effective_m(h, m)


def _am_tree(hidden, seed=0):
    cfg = jam.LSTMAMConfig(input_dim=13, hidden_dim=hidden, n_layers=2,
                           n_classes=9)
    return jax.tree.map(np.asarray, jam.init_params(jax.random.key(seed), cfg))


@pytest.mark.parametrize("gamma,m", [(0.75, 4), (0.9375, 64), (0.5, 3)])
def test_prune_tree_over_the_acoustic_model_bit_equal(gamma, m):
    """The trainer's layout {"w_x", "w_h", "fcl/w"} matches the same
    "/"-joined leaves ("lstm/0/w_x", "fcl/w", ...) in both; the logit layer
    and biases pass through."""
    params = _am_tree(32)
    layout_j = {k: jcbtd.CBTDConfig(gamma=gamma, m=m)
                for k in ("w_x", "w_h", "fcl/w")}
    layout_t = {k: tcbtd.CBTDConfig(gamma=gamma, m=m)
                for k in ("w_x", "w_h", "fcl/w")}
    want = jcbtd.cbtd_prune_tree(jax.tree.map(jnp.asarray, params),
                                 layout_j, 1.0)
    got = tcbtd.cbtd_prune_tree(tam.params_from_numpy(params, device="cpu"),
                                layout_t, 1.0)
    np.testing.assert_array_equal(got["logit"]["w"].numpy(),
                                  params["logit"]["w"])
    for li in range(2):
        for k in ("w_x", "w_h", "b"):
            np.testing.assert_array_equal(got["lstm"][li][k].numpy(),
                                          _np(want["lstm"][li][k]))
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["fcl"][k].numpy(),
                                      _np(want["fcl"][k]))
    assert float((got["lstm"][0]["w_h"] == 0).float().mean()) > 0
    # below alpha 1 (deterministic) nothing is pruned
    same = tcbtd.cbtd_prune_tree(tam.params_from_numpy(params, device="cpu"),
                                 layout_t, 0.5)
    np.testing.assert_array_equal(same["fcl"]["w"].numpy(),
                                  params["fcl"]["w"])


def test_prune_tree_stacked_wildcard_and_tile_leaves_bit_equal():
    rng = np.random.default_rng(4)
    tree = {"blocks": {"w": rng.standard_normal((3, 2, 32, 16)).astype(
                np.float32)},
            "proj": [rng.standard_normal((24, 8)).astype(np.float32),
                     rng.standard_normal((8,)).astype(np.float32)]}
    for layout_args in ({"*": dict(gamma=0.5, m=16)},
                        {"w": dict(gamma=0.5, granularity="tile",
                                   tile=(8, 8))}):
        want = jcbtd.cbtd_prune_tree(
            jax.tree.map(jnp.asarray, tree),
            {k: jcbtd.CBTDConfig(**v) for k, v in layout_args.items()}, 1.0)
        got = tcbtd.cbtd_prune_tree(
            {"blocks": {"w": torch.tensor(tree["blocks"]["w"])},
             "proj": [torch.tensor(a) for a in tree["proj"]]},
            {k: tcbtd.CBTDConfig(**v) for k, v in layout_args.items()}, 1.0)
        np.testing.assert_array_equal(got["blocks"]["w"].numpy(),
                                      _np(want["blocks"]["w"]))
        for a, b in zip(got["proj"], want["proj"]):
            np.testing.assert_array_equal(a.numpy(), _np(b))


def test_sparsity_statistics_equal():
    rng = np.random.default_rng(9)
    masks = rng.random((50, 1147)) < 0.3
    nnz_dx = rng.integers(0, 123, 50).astype(np.int32)
    nnz_dh = rng.integers(0, 1024, 50).astype(np.int32)
    w = _weights(1, (64, 32))
    w[w < 0.3] = 0
    tm = torch.tensor(masks)
    assert float(tcore.temporal_sparsity(tm)) == pytest.approx(
        float(jcore.temporal_sparsity(jnp.asarray(masks))), rel=1e-6)
    assert float(tcore.weight_sparsity(torch.tensor(w))) == float(
        jcore.weight_sparsity(jnp.asarray(w)))
    for n in (1, 8, 7):
        assert float(tcore.balance_ratio(tm, n)) == pytest.approx(
            float(jcore.balance_ratio(jnp.asarray(masks), n)), rel=1e-6)
    tree = _am_tree(16)
    assert tcore.tree_weight_sparsity(
        tam.params_from_numpy(tree, device="cpu")) == \
        jcore.tree_weight_sparsity(tree)
    np.testing.assert_allclose(
        tcore.effective_mac_trace(torch.tensor(nnz_dx), torch.tensor(nnz_dh),
                                  123, 1024, 0.9375).numpy(),
        _np(jcore.effective_mac_trace(jnp.asarray(nnz_dx),
                                      jnp.asarray(nnz_dh), 123, 1024,
                                      0.9375)), rtol=1e-6)
    got = tcore.summarize_delta_aux({"nnz_dx": torch.tensor(nnz_dx),
                                     "nnz_dh": torch.tensor(nnz_dh)},
                                    123, 1024)
    want = jcore.summarize_delta_aux({"nnz_dx": jnp.asarray(nnz_dx),
                                      "nnz_dh": jnp.asarray(nnz_dh)},
                                     123, 1024)
    assert got == pytest.approx(want, rel=1e-6)
    for fn in ("lstm_layer_macs", "lstm_layer_ops"):
        assert getattr(tcore, fn)(123, 1024) == getattr(jcore, fn)(123, 1024)
    assert tcore.op_saving(0.9375, 0.906) == jcore.op_saving(0.9375, 0.906)
    assert tcore.model_size_mb(4_700_000, 8) == jcore.model_size_mb(
        4_700_000, 8)
    assert tcore.sparse_model_size_mb(4_700_000, 0.9375, 8, 10) == \
        jcore.sparse_model_size_mb(4_700_000, 0.9375, 8, 10)


def test_quantize_tree_and_int8_unpack_bit_equal():
    tree = _am_tree(32, seed=3)
    tree["logit"]["b"] = np.linspace(-2, 2, 9).astype(np.float32)
    want = jcore.quantize_tree(jax.tree.map(jnp.asarray, tree), bits=8)
    got = tcore.quantize_tree(tam.params_from_numpy(tree, device="cpu"),
                              bits=8)
    for li in range(2):
        for k in ("w_x", "w_h", "b"):
            np.testing.assert_array_equal(got["lstm"][li][k].numpy(),
                                          _np(want["lstm"][li][k]))
    np.testing.assert_array_equal(got["logit"]["b"].numpy(),
                                  _np(want["logit"]["b"]))
    w = tree["fcl"]["w"]
    q, scale = tcore.int8_pack(torch.tensor(w))
    np.testing.assert_array_equal(
        tcore.int8_unpack(q, scale).numpy(),
        _np(jcore.int8_unpack(*jcore.int8_pack(jnp.asarray(w)))))


def test_batched_layers_n_params_and_weight_layout():
    tree = _am_tree(16, seed=5)
    lp = tree["lstm"][0]
    xs = np.random.default_rng(2).standard_normal((3, 6, 13)).astype(
        np.float32)
    tlp = tam.params_from_numpy(lp, device="cpu")
    np.testing.assert_allclose(
        tcore.lstm_layer_batched(tlp, torch.tensor(xs)).numpy(),
        _np(jcore.lstm_layer_batched(jax.tree.map(jnp.asarray, lp),
                                     jnp.asarray(xs))), atol=1e-6)
    hs_t, _, aux_t = tcore.delta_lstm_layer_batched(tlp, torch.tensor(xs),
                                                    0.1)
    hs_j, _, aux_j = jcore.delta_lstm_layer_batched(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(xs), 0.1)
    np.testing.assert_allclose(hs_t.numpy(), _np(hs_j), atol=1e-6)
    np.testing.assert_array_equal(aux_t["nnz_dx"].numpy(),
                                  _np(aux_j["nnz_dx"]))
    assert tam.n_params(tam.params_from_numpy(tree, device="cpu")) == \
        jam.n_params(tree)
    layout_t, layout_j = tam.lstm_weight_layout(), jam.lstm_weight_layout()
    assert list(layout_t) == list(layout_j)
    for k in layout_j:
        assert vars(layout_t[k]) == vars(layout_j[k])
