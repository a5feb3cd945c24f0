"""The port's hot-path contracts (repro_torch.analysis) on the CPU.

Every case of ``cases.build_cases()`` (the reference's 14 unsharded
cases, by the same names, at the reference's test scale) passes, and so
does every ``cases.served_cases()`` case at the served capacity; the
port registers the same contracts as the reference, by name and clause,
but for one stricter clause (the dense route's ``sort: 0``);
each clause catches the fault it names on a small function built to
commit it; and restoring the float64 dense mirror fails ``max_dtype``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_contracts.py

(``tests/test_torch_gpu.py::test_contract_cases_on_card`` checks the same
cases on the card, and ``chip_smoke.py`` phase 6 at full width.)
"""
import dataclasses
from typing import NamedTuple

import pytest
import torch

from repro_torch.analysis import cases, contracts, hlo
from repro_torch.kernels import ops

CASE_NAMES = [
    "step_frames/unsharded", "step_chunk/dense-mirror", "step_chunk/scatter",
    "step_chunk/post-restore", "stsp_spmv_batch/xla-scatter",
    "stsp_spmv_batch/pallas", "stsp_spmv_batch/dense-mirror",
    "step_chunk/quant-int8", "stsp_spmv_batch/quant-scatter",
    "stsp_spmv_batch/quant-dense-mirror", "fold_totals", "bank_rows",
    "gather_rows", "gather_frames",
]


def _case(name):
    return {c.name: c for c in cases.build_cases(device="cpu")}[name]


def test_cases_are_the_references_unsharded_cases():
    from repro.analysis import cases as jcases

    want = [(c.name, c.contract, dict(c.op_budget_override))
            for c in jcases.build_cases(include_sharded=False)]
    got = [(c.name, c.contract, dict(c.op_budget_override))
           for c in cases.build_cases(device="cpu", include_sharded=False)]
    assert got == want
    assert [n for n, _, _ in got] == CASE_NAMES


@pytest.mark.parametrize("name", CASE_NAMES)
def test_port_case_passes(name):
    report = contracts.check_case(_case(name))
    assert report.ok, [str(v) for v in report.violations]
    contract = contracts.get_contract(report.contract)
    # donation: every donated leaf written in place and returned
    assert report.alias_entries == report.donated_leaves
    assert (report.donated_leaves > 0) == bool(contract.donates)
    if name.startswith("step_chunk/"):
        assert report.op_histogram.get("dynamic-update-slice") == 1
        kernel = ("kernel:stsp_spmv_scatter_batch" if name.endswith("scatter")
                  else "kernel:dense_mirror")
        assert report.op_histogram[kernel] == 8     # 4 frames x 2 layers


def test_cases_with_the_sharded_case_are_the_references():
    from repro.analysis import cases as jcases

    want = [(c.name, c.contract, dict(c.op_budget_override))
            for c in jcases.build_cases(include_sharded=True)]
    got = [(c.name, c.contract, dict(c.op_budget_override))
           for c in cases.build_cases(device="cpu")]
    assert got == want
    assert got[-1][0] == "step_chunk/sharded-4dev"


def _sharded_case():
    return {c.name: c for c in cases.build_cases(device="cpu")}[
        "step_chunk/sharded-4dev"]


def test_sharded_case_passes():
    """8 slots over 4 logical shards: every clause of ``step_chunk``
    over the whole chunk, each shard's part the unsharded chunk at 2
    slots, and no op touching two shards' tensors."""
    case = _sharded_case()
    built = case.build()
    report = contracts.check_built(case, built)
    assert report.ok, [str(v) for v in report.violations]
    assert report.alias_entries == report.donated_leaves > 0
    assert len(built.shards) == 4
    assert not any(a & b for i, a in enumerate(built.shards)
                   for b in built.shards[i + 1:])
    assert report.op_histogram["kernel:dense_mirror"] == 4 * 8
    assert report.op_histogram["dynamic-update-slice"] == 4
    for op, n in built.shard_histogram.items():
        assert report.op_histogram[op] == 4 * n, op


def test_sharded_case_catches_a_copy_between_shards():
    """A chunk that reads one shard's frames into another's fails
    ``cross_shard``; one that skips a shard's layer fails
    ``shard_histogram``."""
    case = _sharded_case()
    built = case.build()

    class Leaky:
        """Shard 0's engine, reading shard 1's frames into its own."""

        def __init__(self, engine, src):
            self.engine, self.src = engine, src

        def step_chunk(self, state, frames, *args, **kwargs):
            frames.copy_(self.src)
            return self.engine.step_chunk(state, frames, *args, **kwargs)

    engines = list(built.kwargs["engines"])
    engines[0] = Leaky(engines[0], built.args[1][1])
    built.kwargs["engines"] = tuple(engines)
    report = contracts.check_built(case, built)
    crossing = [v for v in report.violations if v.clause == "cross_shard"]
    assert len(crossing) == 1 and "shard 0:" in crossing[0].message
    # the extra copy also shows in shard 0's histogram
    assert {v.clause for v in report.violations} == {"cross_shard",
                                                     "shard_histogram"}

    built = case.build()
    built.shard_histogram = {**built.shard_histogram,
                             "kernel:delta_encode": 0}
    report = contracts.check_built(case, built)
    assert {v.clause for v in report.violations} == {"shard_histogram"}


def test_sharded_case_traces_the_pools_own_dispatch(monkeypatch):
    """The sharded case traces ``sharding.dispatch_chunk``, the function a
    sharded ``SessionPool.step_chunk`` dispatches its shards with, so a
    change to the pool's per-shard loop is a change to what the contract
    checks."""
    import numpy as np

    from repro_torch.launch.mesh import emulated_devices
    from repro_torch.serving import sharding
    from repro_torch.serving.scheduler import SessionPool, StreamRequest

    assert _sharded_case().build().fn is sharding.dispatch_chunk
    calls = []
    real = sharding.dispatch_chunk

    def spy(*args, **kwargs):
        calls.append(len(kwargs["engines"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(sharding, "dispatch_chunk", spy)
    width = cases.WIDTHS["test"]
    with emulated_devices(4):
        pool = SessionPool(cases._engine(width, torch.device("cpu")),
                           capacity=8, max_frames=width.max_frames,
                           chunk_frames=width.chunk, n_devices=4)
    rng = np.random.default_rng(0)
    for i in range(8):
        pool.admit(StreamRequest(i, 0, rng.standard_normal(
            (5, width.input_dim)).astype(np.float32)), 0)
    pool.step_chunk(0)
    assert calls == [4]


SERVED_NAMES = [
    "step_chunk/dense-mirror@served", "step_chunk/quant-int8@served",
    "step_chunk/scatter@served", "stsp_spmv_batch/dense-mirror@served",
    "stsp_spmv_batch/quant-dense-mirror@served",
]


def _served(name):
    return {c.name: c for c in cases.served_cases(device="cpu")}[name]


@pytest.mark.parametrize("name", SERVED_NAMES)
def test_served_case_passes(name):
    """The served capacity (0.5 of Q) clips on every layer-frame: the
    dense route's count and clip are one kernel that sorts nothing, so
    each dense-mirror chunk holds the reference's ``sort: 0``, one clip
    and one product a layer-frame, and every other clause as declared."""
    case = _served(name)
    report = contracts.check_case(case)
    assert report.ok, [str(v) for v in report.violations]
    assert report.alias_entries == report.donated_leaves
    hist = report.op_histogram
    if name.startswith("stsp_spmv_batch/"):
        assert "sort" not in hist
        assert hist["kernel:capacity_clip"] == hist["kernel:dense_mirror"] \
            == 1
    elif name != "step_chunk/scatter@served":
        assert case.op_budget_override == {"sort": 0}
        assert "sort" not in hist
        assert hist["kernel:capacity_clip"] == 8     # 4 frames x 2 layers
        assert hist["kernel:dense_mirror"] == 8


def test_served_dense_chunk_fails_the_references_sort_budget(monkeypatch):
    """The reference's ``sort: 0`` is a real bound on the served dense
    chunk: the chunk meets it, and the same chunk with the clip's top-k
    chain back outside a kernel (the port's dense route before its clip
    kernel) fails it on ``op_budget`` alone."""
    from repro_torch.kernels import capacity_clip

    case = _served("step_chunk/dense-mirror@served")
    assert case.op_budget_override == {"sort": 0}
    assert contracts.check_case(case).ok
    monkeypatch.setattr(capacity_clip, "capacity_clip", capacity_clip.plain)
    report = contracts.check_case(case)
    assert [v.clause for v in report.violations] == ["op_budget"]
    assert report.op_histogram["sort"] == 8


def test_registry_equals_the_references():
    from repro.analysis import contracts as jcontracts
    from repro.kernels import ops as jops  # noqa: F401  (registers)
    from repro.serving import batched_engine, telemetry  # noqa: F401
    from repro_torch.serving import batched_engine as tbe  # noqa: F401

    def table(registry):
        return {name: {f.name: (dict(getattr(c, f.name))
                                if f.name == "op_budget"
                                else getattr(c, f.name))
                       for f in dataclasses.fields(c)}
                for name, c in registry.items()}

    want = table(jcontracts.registered_contracts())
    got = table(contracts.registered_contracts())
    # the one stricter clause: the port's count and clip sort nothing
    assert want["delta_spmv_dense_topk"]["op_budget"]["sort"] == 1
    assert got["delta_spmv_dense_topk"]["op_budget"]["sort"] == 0
    got["delta_spmv_dense_topk"]["op_budget"]["sort"] = 1
    assert got == want
    assert len(got) == 8


def test_contract_decorator_costs_nothing_per_call():
    assert ops.gather_frames.__hotpath_contract__ is \
        contracts.get_contract("gather_frames")
    assert ops.gather_frames.__name__ == "gather_frames"    # not a wrapper


# -- one negative case per clause -------------------------------------------


def _check(contract, fn, *args):
    _, trace = hlo.trace(fn, *args)
    return [v.clause for v in contracts.check_trace(contract, trace)]


def test_forbid_ops_catches_a_materialised_weight_transpose():
    c = contracts.HotpathContract("neg", forbid_ops=("transpose",))
    x, w = torch.randn(4, 8), torch.randn(6, 8)
    assert _check(c, lambda x, w: x @ w.T.contiguous(), x, w) \
        == ["forbid_ops"]
    # a transposed view feeding the product moves no data
    assert _check(c, lambda x, w: x @ w.T, x, w) == []


def test_no_host_transfers_catches_item():
    c = contracts.HotpathContract("neg")
    x = torch.randn(4)
    assert _check(c, lambda x: x * x.sum().item(), x) == ["no_host_transfers"]
    assert _check(c, lambda x: x * x.sum(), x) == []


def test_max_dtype_catches_a_float64_tensor():
    c = contracts.HotpathContract("neg")
    x = torch.randn(4)
    assert _check(c, lambda x: (x.double() * 2).float(), x) == ["max_dtype"]
    assert contracts.check_trace(
        dataclasses.replace(c, max_dtype="float64"),
        hlo.trace(lambda x: x.double(), x)[1]) == []


def test_op_budget_catches_two_index_copies_against_one():
    c = contracts.HotpathContract("neg",
                                  op_budget={"dynamic-update-slice": 1})
    buf, rows = torch.zeros(6, 3), torch.ones(2, 3)
    one = lambda b: b.index_copy_(0, torch.tensor([0, 1]), rows)  # noqa
    two = lambda b: one(b).index_copy_(0, torch.tensor([4, 5]), rows)  # noqa
    assert _check(c, one, buf) == []
    assert _check(c, two, buf) == ["op_budget"]


def test_no_collectives_catches_an_all_reduce():
    import torch.distributed as dist

    c = contracts.HotpathContract("neg")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert _check(c, lambda x: dist.all_reduce(x), torch.ones(3)) \
            == ["no_collectives"]
    finally:
        dist.destroy_process_group()


class _State(NamedTuple):
    c: torch.Tensor
    h: torch.Tensor


def _donation_report(monkeypatch, fn, *args):
    contract = contracts.HotpathContract("neg/donation", donates=("state",))
    monkeypatch.setitem(contracts._REGISTRY, contract.name, contract)
    case = cases.ContractCase("neg", contract.name, build=None)
    return contracts.check_built(case, cases.BuiltCase(fn, args, {}))


def test_donation_holds_for_an_in_place_update(monkeypatch):
    def step(state):
        state.c.add_(1.0)
        state.h.copy_(torch.tanh(state.c))
        return state

    report = _donation_report(monkeypatch, step,
                              _State(torch.zeros(4), torch.zeros(4)))
    assert report.ok and report.alias_entries == report.donated_leaves == 2


def test_donation_catches_a_rebound_leaf(monkeypatch):
    def step(state):
        return state._replace(c=state.c + 1.0)   # a new tensor, not a write

    report = _donation_report(monkeypatch, step,
                              _State(torch.zeros(4), torch.zeros(4)))
    assert [v.clause for v in report.violations] == ["donation"]
    assert report.alias_entries == 1


def test_donation_catches_a_leaf_rebound_in_a_mutable_argument(monkeypatch):
    def step(state):
        state["c"] = state["c"] + 1.0
        return state

    report = _donation_report(monkeypatch, step,
                              {"c": torch.zeros(4), "h": torch.zeros(4)})
    assert "donation" in [v.clause for v in report.violations]


def test_donation_catches_leaves_that_share_storage(monkeypatch):
    """The reference's ``init_telemetry`` bug: one buffer bound to two
    donated leaves, so a write to one clobbers the other."""
    buf = torch.zeros(4)
    report = _donation_report(monkeypatch, lambda state: state,
                              _State(buf, buf))
    assert [v.clause for v in report.violations] == ["donation"]


# -- the mutation test: the float64 mirror put back -------------------------


def _float64_mirror_matmul(ds, w, scale=None):
    """The dense route before the repair: a float64 GEMM outside any
    kernel."""
    y = (ds.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    return y if scale is None else y * scale


@pytest.mark.parametrize("name", ["step_chunk/dense-mirror",
                                  "step_chunk/quant-int8",
                                  "stsp_spmv_batch/dense-mirror"])
def test_float64_mirror_fails_max_dtype(monkeypatch, name):
    monkeypatch.setattr(ops, "_mirror_matmul", _float64_mirror_matmul)
    report = contracts.check_case(_case(name))
    assert {v.clause for v in report.violations} == {"max_dtype"}


def test_float64_mirror_at_rest_fails_max_dtype():
    """The fp32 pack's old float64-at-rest mirror, handed to the kernel."""
    case = _case("stsp_spmv_batch/dense-mirror")
    built = case.build()
    built.args = (built.args[0].double(),) + built.args[1:]
    report = contracts.check_built(case, built)
    assert {v.clause for v in report.violations} == {"max_dtype"}


def test_kernel_region_is_one_entry_hiding_the_plain_version():
    """On the CPU the HPE's plain version computes in float64 inside its
    region: the trace shows one float32 entry."""
    from repro_torch.kernels import lstm_pointwise as lp

    dm, c = torch.randn(2, 4, 8), torch.randn(2, 8)
    (h, c2), trace = hlo.trace(lp.lstm_pointwise, dm, c)
    assert [e.op for e in trace.entries] == ["kernel:lstm_pointwise"]
    assert hlo.dtype_violation_lines(trace) == []
    assert trace.entries[0].outputs[0].shape == (2, 8)
    assert torch.equal(h, lp.plain(dm, c)[0])
