"""The port's sharded training and its distributed helpers on the CPU
(``repro_torch.distributed.{sharding,hints,compression}``,
``repro_torch.launch.{steps,train,elastic}``), the in-process counterpart
of ``tests/test_distributed.py``.

- Placement: every leaf of the 10 reduced archs' params and AdamW state
  placed on (2, 2) and (1, 8) meshes of logical host devices
  (``emulated_devices``) gathers back bit for bit, and the bytes on each
  device equal the dry run's per-device count.
- The sharded step (reduced qwen3-1.7b, the reference test's set-up):
  on ``best_mesh_for(8)`` = (1, 8), data size 1, four steps are
  ``torch.equal`` to the one-device steps and the loss falls; resharded
  to (2, 2) one more step stays within the zoo's train-step gates of the
  one-device step (1e-4 of max|param|, Adam's sign-free elements at most
  2%) with a finite loss; on (4, 2) a batch the data size divides stays
  within the same gates and one it does not (computed once) is
  ``torch.equal``.
- The launcher's checkpoints: a resume on the same mesh is
  ``torch.equal`` to the uninterrupted run, and a (1, 4) checkpoint
  restored onto (2, 2) holds the same host arrays.
- ``hints``: the spec each call resolves equals the reference's on a
  table covering every branch (the reference's read through a stand-in
  mesh and a recorder in place of ``with_sharding_constraint``); the
  10 reduced archs' forwards are ``torch.equal`` inside and outside a
  mesh context.
- ``compression``: the reference's three test inputs and seeded trees;
  int8 payloads and top-k masks exact, floats within 1e-7;
  ``compressed_psum`` in its three modes against the reference under
  ``jax.vmap(..., axis_name="i")`` over 4 members.

The CPU's ``index_put_`` with accumulation (an embedding's and the MoE
dispatch's backward) sums in a thread-dependent order, so a step is not
reproducible run to run there; the bit-equality tests run under
``torch.use_deterministic_algorithms``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import perf as jperf
from repro.distributed import compression as jcomp
from repro.distributed import hints as jhints
from repro_torch import _tree
from repro_torch import perf as tperf
from repro_torch.configs import REGISTRY
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import hints as thints
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch import elastic as tel
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import api
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, adamw_init

from torch_zoo_parity import ARCHS

ARCH = "qwen3-1.7b"
OPT = AdamWConfig(lr=1e-3)
SEQ = 32
#: the zoo's train-step gates (as chip_smoke.py phase 8 holds them)
PARAM_REL, SIGN_FREE_SHARE = 1e-4, 0.02


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def host_mesh(shape):
    with tmesh.emulated_devices(int(np.prod(shape))):
        return tmesh.compat_make_mesh(shape, ("data", "model"), "cpu")


def init(cfg):
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return params, adamw_init(params)


def batch_of(cfg, n, seed=1):
    return api.make_train_batch(cfg, torch.Generator().manual_seed(seed), n,
                                SEQ)


def assert_trees_equal(got, want):
    for (path, a), b in zip(_tree.leaves_with_path(tsh.host_tree(got)),
                            _tree.leaves(tsh.host_tree(want))):
        assert torch.equal(a, b), path


def assert_within_step_gates(got, want, m_before):
    """``got`` and ``want`` are (params, AdamState) one step after the
    same state; ``m_before`` its first moment.  The gradients are read
    back from the moments (``g = (m' - b1 m) / (1 - b1)``)."""
    (gp, go), (wp, wo) = (tsh.host_tree(t) for t in (got, want))
    pmax = max(float(p.abs().max()) for p in _tree.leaves(wp))
    n_free = n_all = 0
    for (path, a), b, mg, mw, m0 in zip(
            _tree.leaves_with_path(gp), _tree.leaves(wp), _tree.leaves(go.m),
            _tree.leaves(wo.m), _tree.leaves(m_before)):
        g_got = (mg - OPT.b1 * m0) / (1 - OPT.b1)
        g_want = (mw - OPT.b1 * m0) / (1 - OPT.b1)
        free = ((g_want.abs() <= 2 * (g_got - g_want).abs())
                & ((g_want != 0) | (g_got != 0)))
        err = (a.double() - b.double()).abs()
        over = err > PARAM_REL * pmax + torch.where(free, 2 * OPT.lr, 0.0)
        assert not bool(over.any()), (path, float(err.max()), pmax)
        n_free += int(free.sum())
        n_all += free.numel()
    assert n_free <= SIGN_FREE_SHARE * n_all, (n_free, n_all)


# -- placement ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 8)], ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_place_then_gather_round_trips_and_counts_the_dry_runs_bytes(
        name, shape):
    cfg = REGISTRY[name].reduced()
    mesh = host_mesh(shape)
    for tree in init(cfg):
        specs = tsh.param_specs(tree, mesh, cfg)
        placed = tsh.device_put(tree, tsh.to_shardings(specs, mesh))
        for (path, a), b in zip(_tree.leaves_with_path(tsh.host_tree(placed)),
                                _tree.leaves(tree)):
            assert torch.equal(a, b), path
        per = tsh.placed_bytes(placed)
        assert len(per) == mesh.size
        assert set(per) == {dryrun.per_device_bytes(tree, specs, mesh)}
        leaves = _tree.leaves(placed)
        assert all(isinstance(x, tsh.ShardedTensor) for x in leaves)
        # every block a tensor of its own
        ptrs = [s.data_ptr() for x in leaves for s in x.shards if s.numel()]
        assert len(ptrs) == len(set(ptrs))


def test_a_sharded_leaf_takes_its_specs_blocks():
    mesh = host_mesh((2, 4))
    x = torch.arange(4 * 8 * 3.0).reshape(4, 8, 3)
    placed = tsh.NamedSharding(mesh, tsh.P("data", "model")).place(x)
    assert placed.shape == x.shape and placed.ndim == 3
    for i, block in enumerate(placed.shards):
        d, m = divmod(i, 4)
        assert torch.equal(block, x[2 * d:2 * d + 2, 2 * m:2 * m + 2])
    grouped = tsh.NamedSharding(mesh, tsh.P(None, ("data", "model"))).place(x)
    for i, block in enumerate(grouped.shards):
        assert torch.equal(block, x[:, i:i + 1])
    with pytest.raises(ValueError, match="does not split"):
        tsh.NamedSharding(mesh, tsh.P("model")).place(torch.zeros(6))


# -- the sharded step -------------------------------------------------------------


def test_sharded_step_at_data_size_1_is_the_one_device_step(deterministic):
    """The reference test's run: 4 steps on ``best_mesh_for(8)``, the
    same batch each step; then reshard to (2, 2) and one more step."""
    cfg = REGISTRY[ARCH].reduced()
    batch = batch_of(cfg, 8)
    step = tsteps.make_train_step(cfg, OPT, SEQ)
    one = init(cfg)
    with tmesh.emulated_devices(8):
        mesh = tel.best_mesh_for(8, "cpu")
    assert mesh.shape == {"data": 1, "model": 8}
    sharded = tuple(tel.reshard(t, mesh, cfg) for t in init(cfg))
    losses = []
    for _ in range(4):
        *one, m1 = step(*one, batch)
        *sharded, m2 = step(*sharded, batch)
        assert torch.equal(m1["loss"], m2["loss"])
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        assert_trees_equal(sharded, one)
        losses.append(float(m2["loss"]))
    assert losses[-1] < losses[0]
    step_copies = sharded[1].step.shards
    assert len(step_copies) == 8 and all(int(s) == 4 for s in step_copies)

    m_before = tsh.host_tree(one[1].m)
    mesh22 = host_mesh((2, 2))
    resharded = tuple(tel.reshard(tsh.host_tree(t), mesh22, cfg)
                      for t in sharded)
    *resharded, m3 = step(*resharded, batch)
    *one, m1 = step(*one, batch)
    assert np.isfinite(float(m3["loss"]))
    assert abs(float(m3["loss"]) - float(m1["loss"])) <= 1e-5 * float(
        m1["loss"])
    assert_within_step_gates(resharded, one, m_before)


@pytest.mark.parametrize("batch_size,equal", [(8, False), (6, True)],
                         ids=["divisible", "replicated"])
def test_sharded_step_on_four_data_replicas(batch_size, equal,
                                            deterministic):
    """(4, 2): a batch of 8 splits into 4 replicas of 2 (sums in another
    order: the gates); a batch of 6 does not divide, is replicated and
    computed once (bit-equal)."""
    cfg = REGISTRY[ARCH].reduced()
    batch = batch_of(cfg, batch_size)
    step = tsteps.make_train_step(cfg, OPT, SEQ, microbatches=2)
    one = init(cfg)
    m_before = tsh.host_tree(one[1].m)
    mesh = host_mesh((4, 2))
    assert tsh.batch_spec((batch_size, SEQ), mesh)[0] == (
        None if equal else "data")
    sharded = tuple(tel.reshard(t, mesh, cfg) for t in init(cfg))
    *sharded, m2 = step(*sharded, batch)
    *one, m1 = step(*one, batch)
    assert np.isfinite(float(m2["loss"]))
    if equal:
        assert torch.equal(m1["loss"], m2["loss"])
        assert_trees_equal(sharded, one)
    else:
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * float(
            m1["loss"])
        assert_within_step_gates(sharded, one, m_before)


# -- the launcher's checkpoints ---------------------------------------------------

ARGS = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", str(SEQ),
        "--cbtd-gamma", "0.5", "--cbtd-every", "2", "--log-every", "1",
        "--device", "cpu", "--steps", "4"]


def test_resume_on_the_same_mesh_is_the_uninterrupted_run(tmp_path, capsys,
                                                         deterministic):
    """Four steps on (1, 4) with a checkpoint at step 2, the last removed
    and resumed, against four uninterrupted one-device steps (a prune at
    steps 2 and 4 runs on gathered leaves)."""
    ckpt = str(tmp_path / "run")
    straight = tlaunch.main(ARGS)
    with tmesh.emulated_devices(4):
        first = tlaunch.main(ARGS + ["--ckpt-dir", ckpt, "--ckpt-every", "2"])
        mgr = CheckpointManager(ckpt)
        assert mgr.all_steps() == [2, 4]
        import shutil
        shutil.rmtree(tmp_path / "run" / "step_000000004")
        resumed = tlaunch.main(ARGS + ["--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 4} devices=4" in out
    assert "[train] resumed from step 2" in out
    assert resumed.step0 == 2 and resumed.data.step == 4
    assert first.losses == straight.losses
    assert {k: resumed.losses[k] for k in (3, 4)} == {
        k: straight.losses[k] for k in (3, 4)}
    for run in (first, resumed):
        assert_trees_equal((run.params, run.opt_state),
                           (straight.params, straight.opt_state))


def test_checkpoint_restores_across_meshes(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    with tmesh.emulated_devices(4):
        run = tlaunch.main(ARGS + ["--steps", "1", "--ckpt-dir", ckpt])
    capsys.readouterr()
    cfg = REGISTRY[ARCH].reduced()
    mgr = CheckpointManager(ckpt)
    (params, opt), meta, at = mgr.restore_latest((run.params, run.opt_state))
    assert at == 1 and meta["data_step"] == 1
    assert all(isinstance(x, np.ndarray) for x in _tree.leaves(params))
    mesh22 = host_mesh((2, 2))
    placed = tuple(tel.reshard(t, mesh22, cfg) for t in (params, opt))
    assert all(x.mesh is mesh22 for x in _tree.leaves(placed))
    arrays, _ = mgr.restore_arrays(1)
    for (path, x) in _tree.leaves_with_path(tsh.host_tree(placed)):
        assert np.array_equal(x.numpy(), arrays[path]), path
    # and straight from one mesh's shards to another's
    direct = tel.reshard(run.params, mesh22, cfg)
    assert_trees_equal(direct, run.params)


# -- hints ------------------------------------------------------------------------

MESHES = {
    "none": None,
    "data4": (("data",), (4,)),
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "4x2": (("data", "model"), (4, 2)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
    "3x1": (("data", "model"), (3, 1)),
}
HINT_CASES = [
    # (mesh, call, shapes, extra, variant)
    *[(m, "constrain", [(8, 16, 6)], ("batch", "model", None), {})
      for m in MESHES],
    ("2x4", "constrain", [(6, 16, 6)], ("batch", "model", "data"), {}),
    ("2x4", "constrain", [(8, 6, 8)], (None, "model", "pod"), {}),
    ("2x2x2", "constrain", [(6, 4, 4)], ("batch", "pod", "model"), {}),
    ("2x4", "constrain", [(8, 6, 8, 4)], ("batch", None, None, "model"), {}),
    # shard_attn: head TP, sequence parallel, forced SP, neither, no model
    *[(m, "shard_attn", [(2, 16, h, 4)] * 3, (), v)
      for m in ("2x4", "4x2", "2x2x2", "data4", "1x1", "none")
      for h in (8, 6, 3) for v in ({}, {"fsdp_sp": True})],
    ("2x4", "shard_attn", [(2, 6, 6, 4)] * 3, (), {}),
    # shard_attn_decode: head TP, seq-sharded cache, gathered cache
    *[(m, "shard_attn_decode", [(2, 1, h, 4), (2, s, h, 4), (2, s, h, 4)],
       (kv,), v)
      for m in ("2x4", "4x2", "2x2x2", "data4", "none")
      for h, kv in ((8, 4), (8, 2), (6, 3)) for s in (16, 6)
      for v in ({}, {"seq_sharded_decode": False})],
]


class _StandIn:
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _ref_specs(mesh, call, shapes, extra, variant, monkeypatch):
    seen = []
    monkeypatch.setattr(jhints, "_current_axes",
                        lambda: None if mesh is None else _StandIn(*mesh))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append((x.shape, tuple(spec)))
                        or x)
    xs = [jnp.zeros(s, jnp.float32) for s in shapes]
    with jperf.variant(jperf.PerfVariant(**variant)):
        out = getattr(jhints, call)(*xs, *extra)
    return seen, out


def _port_specs(mesh, call, shapes, extra, variant, monkeypatch):
    stand_in = None if mesh is None else tmesh.Mesh(*mesh)
    monkeypatch.setattr(thints, "_current_axes", lambda: stand_in)
    xs = [torch.zeros(s) for s in shapes]
    with tperf.variant(tperf.PerfVariant(**variant)), \
            thints.recorded() as seen:
        out = getattr(thints, call)(*xs, *extra)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o is x for o, x in zip(outs, xs))      # identity on values
    return [(s, tuple(spec)) for s, spec in seen]


@pytest.mark.parametrize("case", range(len(HINT_CASES)))
def test_hints_resolve_the_references_spec(case, monkeypatch):
    which, call, shapes, extra, variant = HINT_CASES[case]
    mesh = MESHES[which]
    want, _ = _ref_specs(mesh, call, shapes, extra, variant, monkeypatch)
    got = _port_specs(mesh, call, shapes, extra, variant, monkeypatch)
    assert got == [(tuple(s), spec) for s, spec in want]


def test_hint_cases_cover_every_branch(monkeypatch):
    """Across the table: head TP, sequence-parallel queries, the
    seq-sharded cache, "batch" resolving to one axis and to a group, and
    the replicated fallback all occur."""
    kinds = set()
    for which, call, shapes, extra, variant in HINT_CASES:
        for shape, spec in _port_specs(MESHES[which], call, shapes, extra,
                                       variant, monkeypatch):
            if call != "constrain":
                kinds.add((call, spec[1:3]))
            kinds.update(("batch", e) for e in spec[:1])
    assert {("shard_attn", (None, "model")), ("shard_attn", ("model", None)),
            ("shard_attn_decode", (None, "model")),
            ("shard_attn_decode", ("model", None)),
            ("batch", "data"), ("batch", ("pod", "data")),
            ("batch", None)} <= kinds


@pytest.mark.parametrize("name", ARCHS)
def test_forward_is_the_same_inside_a_mesh(name):
    cfg = REGISTRY[name].reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = batch_of(cfg, 4)
    plain = api.train_loss(params, cfg, batch)
    mesh = tmesh.Mesh(("data", "model"), (2, 2))
    with tmesh.mesh_context(mesh), thints.recorded() as seen:
        inside = api.train_loss(params, cfg, batch)
    assert torch.equal(plain, inside)
    assert seen and all(len(s) == len(spec) for s, spec in seen)
    assert tmesh.active_mesh() is None


# -- compression ------------------------------------------------------------------


def _j(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)


def _t(tree):
    return _tree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _by_path(tree):
    """{path: numpy leaf} (JAX rebuilds dicts in sorted key order, so
    trees are matched by path, never by leaf order)."""
    return dict(_tree.leaves_with_path(jax.tree.map(np.asarray, tree)))


def _assert_float_tree(got, want, tol=1e-7):
    want = _by_path(want)
    for path, a in _tree.leaves_with_path(got):
        b = want[path]
        assert a.shape == b.shape, path
        err = float(np.max(np.abs(a.numpy().astype(np.float64) - b)))
        assert err <= tol, (path, err)


def _seeded_trees(seed, members=1):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 12), "layers": [(7,), (3, 5, 4)], "b": ()}

    def tree(scale):
        return {"w": (rng.standard_normal(shapes["w"]) * scale
                      ).astype(np.float32),
                "layers": [(rng.standard_normal(s) * scale).astype(np.float32)
                           for s in shapes["layers"]],
                "b": np.float32(rng.standard_normal() * scale)}

    return [(tree(1.0), tree(0.01)) for _ in range(members)]


def test_ef_int8_on_the_reference_tests_input():
    g = {"w": np.asarray(jax.random.normal(jax.random.key(0), (64, 64)))}
    jq, js, jr = jcomp.ef_int8_compress(_j(g), jcomp.init_residual(_j(g)))
    tq, ts, tr = tcomp.ef_int8_compress(_t(g), tcomp.init_residual(_t(g)))
    assert tq["w"].dtype == torch.int8
    assert np.array_equal(tq["w"].numpy(), np.asarray(jq["w"]))
    _assert_float_tree(ts, js)
    _assert_float_tree(tr, jr)
    _assert_float_tree(tcomp.ef_int8_decompress(tq, ts),
                       jcomp.ef_int8_decompress(jq, js))


def test_ef_accumulates_small_signals_as_the_reference():
    g = {"w": np.concatenate([np.full((4,), 1e-4, np.float32),
                              np.full((1,), 10.0, np.float32)])}
    jr, tr = jcomp.init_residual(_j(g)), tcomp.init_residual(_t(g))
    j_sent, t_sent = np.zeros(4), torch.zeros(4)
    for _ in range(2000):
        jq, js, jr = jcomp.ef_int8_compress(_j(g), jr)
        tq, ts, tr = tcomp.ef_int8_compress(_t(g), tr)
        assert np.array_equal(tq["w"].numpy(), np.asarray(jq["w"]))
        j_sent = j_sent + np.asarray(jcomp.ef_int8_decompress(jq, js)["w"][:4])
        t_sent = t_sent + tcomp.ef_int8_decompress(tq, ts)["w"][:4]
    _assert_float_tree(tr, jr)
    assert float(np.max(np.abs(t_sent.double().numpy() - j_sent))) <= 1e-7
    # EF's guarantee holds: within half a quantization step of the signal
    assert float(np.max(np.abs(t_sent.numpy() - 2000 * 1e-4))) <= (
        10.0 / 127 / 2 + 1e-6)


@pytest.mark.parametrize("frac", [0.5, 0.01, 0.3])
def test_topk_masks_match_the_reference(frac):
    cases = [({"w": np.array([0.1, -5.0, 0.2, 3.0], np.float32)},
              {"w": np.zeros(4, np.float32)})] + _seeded_trees(3, 2)
    # ties: equal magnitudes at the threshold keep more than k
    cases.append(({"w": np.array([1.0, -1.0, 1.0, 0.5], np.float32)},
                  {"w": np.zeros(4, np.float32)}))
    for g, r in cases:
        js, jr = jcomp.ef_topk_compress(_j(g), _j(r), frac=frac)
        ts, tr = tcomp.ef_topk_compress(_t(g), _t(r), frac=frac)
        want = _by_path(js)
        for path, a in _tree.leaves_with_path(ts):
            assert np.array_equal(a.numpy() != 0, want[path] != 0), path
        _assert_float_tree(ts, js)
        _assert_float_tree(tr, jr)


def test_int8_on_seeded_trees():
    for g, r in _seeded_trees(5, 3):
        jq, js, jr = jcomp.ef_int8_compress(_j(g), _j(r))
        tq, ts, tr = tcomp.ef_int8_compress(_t(g), _t(r))
        want = _by_path(jq)
        for path, a in _tree.leaves_with_path(tq):
            assert np.array_equal(a.numpy(), want[path]), path
        _assert_float_tree(ts, js)
        _assert_float_tree(tr, jr)


@pytest.mark.parametrize("mode", ["int8", "topk", "none"])
def test_compressed_psum_matches_the_reference_over_four_members(mode):
    members = _seeded_trees(7, 4)
    stack = lambda trees: jax.tree.map(
        lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *trees)
    jg, jr = stack([g for g, _ in members]), stack([r for _, r in members])
    j_out, j_res = jax.vmap(
        lambda g, r: jcomp.compressed_psum(g, r, "i", mode),
        axis_name="i")(jg, jr)
    t_out, t_res = tcomp.compressed_psum([_t(g) for g, _ in members],
                                         [_t(r) for _, r in members], mode)
    assert len(t_out) == len(t_res) == 4
    for i in range(4):
        pick = lambda t: jax.tree.map(lambda a: a[i], t)
        want = jax.tree.map(np.asarray, pick(j_out))
        scale = max(float(np.max(np.abs(a))) for a in jax.tree.leaves(want))
        _assert_float_tree(t_out[i], want, tol=1e-7 * max(scale, 1.0))
        _assert_float_tree(t_res[i], pick(j_res))
    assert all(a is not b for a, b in zip(_tree.leaves(t_out[0]),
                                          _tree.leaves(t_out[1])))
