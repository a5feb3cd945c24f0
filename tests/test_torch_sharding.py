"""Port parity of the mesh and the partition rules
(``repro_torch.launch.{mesh,elastic,steps}``,
``repro_torch.distributed.sharding``) at full width, on shape-only trees.

For all 10 registry archs, on the production meshes (16,16) and
(2,16,16) and on ``best_mesh_for(n)`` for n in {1, 2, 8, 256}, each under
``PerfVariant()`` and ``PerfVariant(fsdp_sp=True)``: ``param_specs`` of
the params and AdamW trees (``abstract_params``/``abstract_opt_state``),
``cache_specs`` of ``abstract_cache`` in every ``SHAPES`` cell and
``batch_specs`` of the cell's batch equal the reference's
``PartitionSpec`` leaf for leaf.  The reference's meshes are
``AbstractMesh``es (its ``best_mesh_for`` builds one in place of a mesh
over devices this host lacks).  Also ``n_params_of``, ``rescale_batch``,
the placement of a tree on a one-device mesh, and a shape-only mesh's
refusal to hold one.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro import perf as jperf
from repro.configs import REGISTRY as JREGISTRY
from repro.distributed import sharding as jsh
from repro.launch import elastic as jel
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro_torch import _tree
from repro_torch import perf as tperf
from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import elastic as tel
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.config import SHAPES

ARCHS = sorted(REGISTRY)
MESHES = ["16x16", "2x16x16", "best1", "best2", "best8", "best256"]
VARIANTS = {"baseline": {}, "fsdp_sp": {"fsdp_sp": True}}
#: the reference names AdamState's fields ``.step``, ``.m``, ``.v``;
#: the port's tree paths name them by index
ADAM_FIELDS = {".step": "0", ".m": "1", ".v": "2"}


def _abstract(shape, axes):
    return jax.sharding.AbstractMesh(tuple(shape), tuple(axes))


def meshes(which, monkeypatch):
    """(reference mesh, port mesh) for a name of ``MESHES``."""
    if which == "16x16":
        return (_abstract((16, 16), ("data", "model")),
                tmesh.make_production_mesh())
    if which == "2x16x16":
        return (_abstract((2, 16, 16), ("pod", "data", "model")),
                tmesh.make_production_mesh(multi_pod=True))
    n = int(which[len("best"):])
    monkeypatch.setattr(jel, "compat_make_mesh", _abstract)
    return jel.best_mesh_for(n), tel.best_mesh_for(n, "meta")


@functools.lru_cache(maxsize=None)
def abstract_trees(name):
    """(reference params, reference AdamW state, port params, port AdamW
    state), all shape-only, at full width."""
    jp = jsteps.abstract_params(JREGISTRY[name])
    tp = tsteps.abstract_params(REGISTRY[name])
    return (jp, jsteps.abstract_opt_state(jp), tp,
            tsteps.abstract_opt_state(tp))


def ref_flat(spec_tree):
    """{port path: spec as a tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        name = jsh._leaf_name(path)
        head, _, rest = name.partition("/")
        if head in ADAM_FIELDS:
            name = ADAM_FIELDS[head] + ("/" + rest if rest else "")
        out[name] = tuple(spec)
    return out


def port_flat(spec_tree, like):
    """{path: spec as a tuple} of a port spec tree built from ``like``."""
    specs = []
    _tree.tree_map(specs.append, spec_tree, is_leaf=tsh.is_spec)
    assert all(isinstance(s, tsh.PartitionSpec) for s in specs)
    return dict(zip((p for p, _ in _tree.leaves_with_path(like)),
                    map(tuple, specs)))


def assert_same_specs(want, got, what):
    assert sorted(got) == sorted(want), what
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, f"{what}: {diff}"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_opt_specs_match_reference(name, variant, monkeypatch):
    jp, jo, tp, to = abstract_trees(name)
    jcfg, tcfg = JREGISTRY[name], REGISTRY[name]
    kw = VARIANTS[variant]
    n_sharded = 0
    for which in MESHES:
        jm, tm = meshes(which, monkeypatch)
        assert dict(jm.shape) == tm.shape
        with jperf.variant(jperf.PerfVariant(**kw)), \
                tperf.variant(tperf.PerfVariant(**kw)):
            for jtree, ttree, what in ((jp, tp, "params"),
                                       (jo, to, "adamw")):
                want = ref_flat(jsh.param_specs(jtree, jm, jcfg))
                got = port_flat(tsh.param_specs(ttree, tm, tcfg), ttree)
                assert_same_specs(want, got, f"{name} {which} {what}")
                n_sharded += sum(any(e is not None for e in s)
                                 for s in got.values())
    assert n_sharded > 0      # the rules shard something on some mesh


@pytest.mark.parametrize("name", ARCHS)
def test_cache_and_batch_specs_match_reference(name, monkeypatch):
    jcfg, tcfg = JREGISTRY[name], REGISTRY[name]
    for which in MESHES:
        jm, tm = meshes(which, monkeypatch)
        for jcell, tcell in zip(JSHAPES, SHAPES):
            jc = jsteps.abstract_cache(jcfg, jcell)
            tc = tsteps.abstract_cache(tcfg, tcell)
            assert all(l.device.type == "meta" for l in _tree.leaves(tc))
            want = ref_flat(jsh.cache_specs(jc, jm))
            got = port_flat(tsh.cache_specs(tc, tm), tc)
            assert_same_specs(want, got, f"{name} {which} {tcell.name} cache")
            b, s = tcell.global_batch, tcell.seq_len
            shapes = {"tokens": (b, s), "targets": (b, s),
                      "inputs_embeds": (b, s, tcfg.d_model)}
            want = ref_flat(jsh.batch_specs(
                {k: jax.ShapeDtypeStruct(v, np.float32)
                 for k, v in shapes.items()}, jm))
            tb = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
            got = port_flat(tsh.batch_specs(tb, tm), tb)
            assert_same_specs(want, got, f"{name} {which} {tcell.name} batch")


@pytest.mark.parametrize("name", ARCHS)
def test_n_params_and_abstract_trees_match_reference(name):
    """``n_params_of`` equals the reference's exact count.  The reference
    takes each leaf's size as an int32 ``jnp.prod``, which wraps for a
    leaf of 2**31 elements or more (granite-34b, internlm2-20b and
    olmoe-1b-7b have such leaves): its own ``n_params_of`` is compared
    only where no leaf wraps."""
    jp, jo, tp, to = abstract_trees(name)
    for jtree, ttree in ((jp, tp), (jo, to)):
        sizes = [math.prod(l.shape) for l in jax.tree.leaves(jtree)]
        assert tsteps.n_params_of(ttree) == sum(sizes)
        if max(sizes) < 2**31:
            assert tsteps.n_params_of(ttree) == jsteps.n_params_of(jtree)
    want = {jsh._leaf_name(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in _tree.leaves_with_path(tp)}
    assert got == want
    assert all(l.device.type == "meta" for l in _tree.leaves(to))


def test_abstract_params_record_the_real_initialisation():
    """The shape-only tree has the real init's leaves, shapes and dtypes,
    and making it draws from no generator (the global one untouched)."""
    from repro_torch.models import api

    for name in ARCHS:
        cfg = REGISTRY[name].reduced()
        state = torch.random.get_rng_state()
        abs_ = tsteps.abstract_params(cfg, torch.float32)
        assert torch.equal(state, torch.random.get_rng_state())
        real = api.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        assert [(p, l.shape, l.dtype) for p, l in
                _tree.leaves_with_path(abs_)] == [
            (p, l.shape, l.dtype) for p, l in _tree.leaves_with_path(real)]


@pytest.mark.parametrize("args", [(256, 4, 2, 64), (256, 4, 1, 64),
                                  (64, 2, 8, 32), (96, 3, 2, 32),
                                  (8, 1, 1, 8), (512, 2, 3, 256)])
def test_rescale_batch_matches_reference(args):
    assert tel.rescale_batch(*args) == jel.rescale_batch(*args)


def test_rescale_batch_rejects_an_inconsistent_global_batch():
    with pytest.raises(ValueError, match="global batch"):
        tel.rescale_batch(100, 4, 2, 32)


@pytest.mark.parametrize("which", MESHES)
def test_mesh_axes_match_reference(which, monkeypatch):
    jm, tm = meshes(which, monkeypatch)
    from repro.launch import mesh as jmesh

    assert tm.axis_names == tuple(jm.axis_names)
    assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    assert tmesh.model_axis(tm) == jmesh.model_axis(jm)
    for names in (("data",), ("model",), ("pod", "data"), ("data", "model")):
        assert tmesh.axis_size(tm, *names) == jmesh.axis_size(jm, *names)
    assert tm.devices == ()        # shape only


def test_one_device_mesh_places_every_leaf_whole():
    cfg = REGISTRY["granite-moe-1b-a400m"].reduced()
    from repro_torch.models import api
    from repro_torch.training.optimizer import adamw_init

    mesh = tel.best_mesh_for(1, "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for tree in (params, adamw_init(params)):
        placed = tel.reshard(tree, mesh, cfg)
        for (path, a), b in zip(_tree.leaves_with_path(placed),
                                _tree.leaves(tree)):
            assert a is b, path            # already whole on that device
    with tmesh.mesh_context(mesh):
        pass


def test_placing_shards_on_several_devices_is_refused():
    """Only a shape-only mesh refuses a tree: it has no device to hold
    one.  The same mesh over 8 logical host devices places the leaf as 8
    blocks (``tests/test_torch_distributed.py`` holds placement to the
    rules)."""
    mesh = tel.best_mesh_for(8, "meta")
    params = {"layers": {"mlp": {"gate": {"w": torch.zeros(2, 32, 16)}}}}
    with pytest.raises(ValueError, match="shape-only"):
        tel.reshard(params, mesh)
    with tmesh.emulated_devices(8):
        placed = tel.reshard(params, tel.best_mesh_for(8, "cpu"))
    leaf = placed["layers"]["mlp"]["gate"]["w"]
    assert isinstance(leaf, tsh.ShardedTensor)
    assert [tuple(b.shape) for b in leaf.shards] == [(2, 4, 16)] * 8


def test_meshes_over_missing_devices_raise():
    with pytest.raises(ValueError, match="only 1 cpu device"):
        tmesh.make_host_mesh(2, 2)
    assert tmesh.make_host_mesh(1, 1).size == 1
    with pytest.raises(ValueError, match="n_data must be >= 1"):
        tmesh.make_data_mesh(0, "cpu")
    with pytest.raises(ValueError, match="2-device mesh"):
        tmesh.make_data_mesh(2, "cpu")
