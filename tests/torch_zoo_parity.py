"""Shared set-up of the model-zoo parity tests (``tests/test_torch_
models*.py``): the reference's params of each reduced architecture,
carried into the port as numpy, and seeded numpy inputs that both sides
take.  Not a test module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models import api as japi
from repro_torch.configs import REGISTRY
from repro_torch.models import api as tapi

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
