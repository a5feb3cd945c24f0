"""The roofline and MFU arithmetic on hand-worked cases, and the traced
run's counters at the port's ops boundary."""
import pytest
import torch

from bench import counting, instrument
from bench.program import import_port, ops_module

import_port()


def test_dense_mirror_call_counts_the_union_once():
    # 3 rows over q=5 columns, fired: row0 {0, 2}, row1 {2}, row2 {4}
    # union {0, 2, 4}: 3 mirror rows of n=8 fp32 weights; deltas 3x5x4,
    # outputs 3x8x4; 4 fired entries x 8 outputs x 2
    n_bytes, ops = counting.dense_mirror_call(3, 4, 3, 5, 8, 4)
    assert n_bytes == 3 * 8 * 4 + 3 * 5 * 4 + 3 * 8 * 4
    assert ops == 2 * 4 * 8


def test_stsp_spmv_call():
    # union of 2 columns, each m=4 PEs x blen=2 (int8 value, int8 index);
    # 2 lists of k=3 (int32 index + fp32 value); 2 x 16 outputs
    n_bytes, ops = counting.stsp_spmv_call(2, 3, 2, 3, 4, 2, 1, 1, 16)
    assert n_bytes == 2 * 4 * 2 * 2 + 2 * 3 * 8 + 2 * 16 * 4
    assert ops == 2 * 3 * 4 * 2


def test_bound_is_the_slower_of_bytes_and_operations():
    p = counting.PEAKS
    assert counting.bound_s(p["hbm_bytes_per_s"], 0) == pytest.approx(1.0)
    assert counting.bound_s(0, p["fp32_flops_per_s"] * 2) == \
        pytest.approx(2.0)
    t = counting.bound_s(torch.tensor(p["hbm_bytes_per_s"] * 3.0),
                         torch.tensor(p["fp32_flops_per_s"]))
    assert float(t) == pytest.approx(3.0)


def test_counters_at_the_ops_boundary():
    ops = ops_module()
    c = instrument.Counters(ops, row_width=5, device=torch.device("cpu"))
    c.install()
    try:
        ds = torch.zeros(3, 5)
        ds[0, 0], ds[0, 2], ds[1, 2], ds[2, 4] = 1.0, -2.0, 0.5, 3.0
        wt = torch.ones(5, 8)
        ops._mirror_matmul(ds, wt)            # not counted: inactive
        c.active = True
        y = ops._mirror_matmul(ds, wt)
        assert torch.equal(y, ds @ wt)
        # CBCSC: q=6 columns, m=4, blen=2; lists of k=3, two of them
        val = torch.ones(6, 4, 2, dtype=torch.int8)
        lidx = torch.zeros(6, 4, 2, dtype=torch.int8)
        idx = torch.tensor([[1, 3, 0], [3, 0, 0]], dtype=torch.int32)
        vals = torch.tensor([[1.0, 2.0, 0.0], [4.0, 0.0, 0.0]])
        ops.stsp_spmv_batch(val, lidx, idx, vals, s=4)
        active = torch.tensor([True, False, True])
        x = torch.randn(3, 5)
        ops.delta_encode_step(x, torch.zeros(3, 2), torch.zeros(3, 7), 0.3,
                              active=active)
        # a layer past the first: x as wide as h, fired kept apart, no row
        x2 = torch.randn(3, 2)
        ops.delta_encode_step(x2, torch.zeros(3, 2), torch.zeros(3, 4), 0.3)
        out = c.read()
    finally:
        c.uninstall()
    assert ops._mirror_matmul.__name__ == "_mirror_matmul"
    mirror = out["dense_mirror"]
    assert mirror["calls"] == 1
    assert mirror["bytes"] == 3 * 8 * 4 + 3 * 5 * 4 + 3 * 8 * 4
    assert mirror["ops"] == 2 * 4 * 8
    spmv = out["stsp_spmv"]
    # union {1, 3}; 3 nonzero list entries
    assert spmv["bytes"] == 2 * 4 * 2 * 2 + 2 * 3 * 8 + 2 * 16 * 4
    assert spmv["ops"] == 2 * 3 * 4 * 2
    fired = (x.abs() > 0.3).sum(1)
    fired2 = int((x2.abs() > 0.3).sum())
    assert out["fired"]["by_width"] == {2: float(fired2),
                                        5: float(fired[0] + fired[2])}
    assert out["fired"]["rows"] == 2.0


def test_idle_time_is_attributed_to_the_host_spans():
    # device busy [1, 2) and [4, 5) inside the window [0, 6)
    ops = [("k", 1.0, 1.0), ("k", 4.0, 0.5), ("k", 4.25, 0.75)]
    spans = [("dispatch", 0.0, 1.5), ("delivery_pump", 2.5, 3.0)]
    got = dict(instrument.idle_by_span(ops, spans, 0.0, 6.0))
    assert got["dispatch"] == pytest.approx(1.0)        # [0, 1)
    assert got["delivery_pump"] == pytest.approx(0.5)   # [2.5, 3)
    assert got["(no span)"] == pytest.approx(2.5)       # [2, 2.5) [3, 4) [5, 6)
    assert instrument.busy_intervals(ops) == [(1.0, 2.0), (4.0, 5.0)]


class _Profile:
    def __init__(self, complete):
        self._complete, self.t_on = complete, 0.0
        self.activations = 0

    def complete(self):
        return self._complete

    def activate(self):
        self.activations += 1

    def finish(self):
        pass


@pytest.mark.parametrize("complete,retries", [(True, 0), (False, 1)])
def test_a_profile_that_lost_its_events_is_taken_once_more(complete,
                                                           retries):
    hooks = instrument.TracedHooks(
        instrument.Counters(ops_module(), 5, torch.device("cpu")),
        _Profile(complete))
    hooks.window_start(0.0)
    n = 0
    while hooks.retry_profile():
        n += 1
    assert n == retries and hooks.profile.activations == retries


def test_idle_share_takes_busy_per_row_at_the_clean_rate():
    from bench.manifest import Manifest
    from bench.tests.conftest import ROOT

    read = Manifest(ROOT).reader("device.idle_share")
    # 1,000 rows/s in the clean third; 400 rows in the profiled third
    # kept the device busy 0.2 s: 0.5 ms a row, so busy half the time
    # at the clean rate (the profiled third alone would read 80% idle)
    rec = {"ta": 0.0, "tb": 1.0, "deliveries": [(0.5, 1000), (2.5, 400)],
           "profile": {"busy_s": 0.2, "window_s": 1.0, "t_on": 2.0,
                       "t_off": 3.0}}
    assert read(rec) == pytest.approx(50.0)
    assert read(dict(rec, deliveries=[(0.5, 1000)])) is None
    assert read(dict(rec, profile=None)) is None
