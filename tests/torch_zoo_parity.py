"""Shared set-up of the model-zoo parity tests (``tests/test_torch_
models*.py``, ``tests/test_torch_train_steps*.py``): the reference's
params of each reduced architecture, carried into the port as numpy,
seeded numpy inputs that both sides take, and the train-step comparison.
Not a test module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as jadamw_init
from repro_torch import _tree
from repro_torch.configs import REGISTRY
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.training.optimizer import AdamWConfig, adamw_init

ARCHS = sorted(REGISTRY)

#: logits and losses: |port - reference| <= REL * max|reference| + ABS
REL, ABS = 1e-5, 1e-6
#: gradients: per leaf, |port - reference| <= GRAD_REL * max|reference|
GRAD_REL = 1e-4


def configs(name):
    """(reference config, port config), both reduced."""
    return JREGISTRY[name].reduced(), REGISTRY[name].reduced()


@functools.lru_cache(maxsize=None)
def ref_params(name):
    """The reference's ``init_params(cfg, jax.random.key(0))`` of the
    reduced arch, as numpy."""
    jcfg, _ = configs(name)
    return jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))


def both_params(name):
    """(reference params as jax arrays, the same params in the port)."""
    tree = ref_params(name)
    return (jax.tree.map(jnp.asarray, tree),
            tapi.params_from_numpy(tree, "cpu"))


def seq_inputs(cfg, batch, seq, seed):
    """Numpy inputs of a sequence forward: tokens, or embeddings for the
    vlm and audio families."""
    rng = np.random.default_rng(seed)
    if cfg.family in ("vlm", "audio"):
        return rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)


def step_inputs(cfg, batch, n, seed):
    """``n`` numpy decode-step inputs: tokens [B, 1], embeddings [B, 1, d]
    for the vlm family."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return [rng.standard_normal((batch, 1, cfg.d_model)).astype(np.float32)
                for _ in range(n)]
    return [rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32)
            for _ in range(n)]


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_close(got, want, what, rel=REL, abs_=ABS):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    tol = rel * float(np.max(np.abs(want))) + abs_
    assert err <= tol, f"{what}: max|diff| {err:.3g} > {tol:.3g}"
    return err


# -- the zoo's train step (tests/test_torch_train_steps*.py) ------------------

FAMILY_ARCH = {"dense": "qwen3-1.7b", "moe": "granite-moe-1b-a400m",
               "vlm": "pixtral-12b", "ssm": "mamba2-130m",
               "hybrid": "recurrentgemma-9b", "audio": "seamless-m4t-medium"}
BATCH, SEQ = 4, 32
OPT = dict(lr=1e-3, warmup_steps=0, schedule="cosine", total_steps=10)
#: elements whose reference gradient lies within the gate of 0 (allowed
#: to move up to 2 lr apart): at most this share of a tree
MAX_SIGN_FREE_SHARE = 0.02
#: leaves whose gradient is exactly 0 at step 1, in the reference and the
#: port alike: the vlm family's inputs_embeds bypass the embedding
ZERO_GRAD_LEAVES = {"vlm": {"embed"}}


def train_batch(cfg, seed=11):
    """A numpy train batch of the family's keys."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        dec = rng.integers(0, cfg.vocab, (BATCH, SEQ // 8)).astype(np.int32)
        return {"frames": rng.standard_normal(
                    (BATCH, SEQ, cfg.d_model)).astype(np.float32),
                "dec_tokens": dec, "dec_targets": dec.copy()}
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    if cfg.family == "vlm":
        return {"inputs_embeds": rng.standard_normal(
                    (BATCH, SEQ, cfg.d_model)).astype(np.float32),
                "targets": toks[:, 1:]}
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _flat(tree):
    return dict(_tree.leaves_with_path(jax.tree.map(np.asarray, tree)))


def _param_bound(p0, g_ref, g_port, gate, lr):
    """The largest |port - reference| an element of the updated params
    may show, and whether its gradient is within the gate of 0 (and not
    exactly 0 on both sides, where neither moves)."""
    free = (np.abs(g_ref) <= gate) & ((g_ref != 0) | (g_port != 0))
    with np.errstate(divide="ignore"):
        tied = lr * 1e-8 * gate / np.maximum(np.abs(g_ref) - gate, 0) ** 2
    bound = np.where(free, 2 * lr, np.minimum(tied, 2 * lr))
    return bound + 2.0 ** -23 * np.abs(p0) + lr * 2.0 ** -21, free


def train_step_parity(family, microbatches):
    """One ``make_train_step`` of ``family``'s arch against the
    reference's (see ``tests/test_torch_train_steps.py``)."""
    name = FAMILY_ARCH[family]
    jcfg, tcfg = configs(name)
    assert tcfg.family == family
    tree = ref_params(name)
    batch = train_batch(tcfg)

    jstep = jsteps.make_train_step(jcfg, JAdamWConfig(**OPT), SEQ,
                                   microbatches=microbatches)
    jp = jax.tree.map(jnp.asarray, tree)
    jp1, jo1, jm = jax.jit(jstep)(jp, jadamw_init(jp),
                                  jax.tree.map(jnp.asarray, batch))

    tstep = tsteps.make_train_step(tcfg, AdamWConfig(**OPT), SEQ,
                                   microbatches=microbatches)
    tp = tapi.params_from_numpy(tree, "cpu")
    tp1, to1, tm = tstep(tp, adamw_init(tp), {k: t(v) for k, v in
                                                batch.items()})

    for key in ("loss", "grad_norm", "lr"):
        assert tm[key].shape == () and tm[key].device.type == "cpu"
        assert_close(tm[key], jm[key], f"{name} {key}")
    assert int(to1.step) == int(jo1.step) == 1

    b1, b2, lr = 0.9, 0.999, float(jm["lr"])
    jflat_m, jflat_v, jflat_p = _flat(jo1.m), _flat(jo1.v), _flat(jp1)
    tflat_m, tflat_v = (dict(_tree.leaves_with_path(to1.m)),
                        dict(_tree.leaves_with_path(to1.v)))
    n_free = n_all = 0
    zero = {path: (not np.any(jflat_m[path]), not bool(tflat_m[path].any()))
            for path in jflat_m}
    assert {p for p, (r, _) in zero.items() if r} == ZERO_GRAD_LEAVES.get(
        family, set()), f"{name}: leaves without gradient {zero}"
    assert all(r == g for r, g in zero.values()), zero
    for path, p0 in _tree.leaves_with_path(tree):
        g_ref = jflat_m[path] / (1 - b1)
        gate = GRAD_REL * float(np.max(np.abs(g_ref))) + 1e-12
        assert_close(tflat_m[path] / (1 - b1), g_ref, f"{name} grad {path}",
                     rel=GRAD_REL, abs_=1e-12)
        assert_close(tflat_v[path], jflat_v[path], f"{name} v {path}",
                     rel=2 * GRAD_REL, abs_=1e-20)
        got = dict(_tree.leaves_with_path(tp1))[path].numpy()
        bound, free = _param_bound(np.asarray(p0), g_ref,
                                   tflat_m[path].numpy() / (1 - b1), gate, lr)
        err = np.abs(got.astype(np.float64) - jflat_p[path])
        worst = np.unravel_index(np.argmax(err - bound), err.shape)
        assert np.all(err <= bound), (
            f"{name} param {path}: |diff| {err[worst]:.3g} > bound "
            f"{bound[worst]:.3g} at {worst} (g {g_ref[worst]:.3g}, "
            f"gate {gate:.3g})")
        n_free += int(free.sum())
        n_all += free.size
    assert n_free <= MAX_SIGN_FREE_SHARE * n_all, (n_free, n_all)
    # the update is donated: the returned params are the given tensors
    for (path, a), b in zip(_tree.leaves_with_path(tp1), _tree.leaves(tp)):
        assert a is b, path
