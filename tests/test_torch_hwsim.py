"""The port's copies of the hardware models (repro_torch.hwsim) give the
reference's outputs exactly, on the paper's layers and on measured-mask
traces."""
import dataclasses

import numpy as np
import pytest

from repro.hwsim import memory as jmem
from repro.hwsim import spartus_model as jhw
from repro_torch.hwsim import memory as tmem
from repro_torch.hwsim import spartus_model as thw

HWS = ("SPARTUS", "EDGE_SPARTUS")
DIMS = ((123, 1024), (1024, 1024), (40, 256))


def _report(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("gamma", [0.0, 0.75, 0.9375])
def test_evaluate_and_baselines_equal(hw, dims, gamma):
    jh, th = getattr(jhw, hw), getattr(thw, hw)
    jd, td = jhw.LayerDims(*dims), thw.LayerDims(*dims)
    assert th.peak_ops() == jh.peak_ops() and th.n_macs == jh.n_macs
    assert (td.n_cols, td.col_height, td.dense_macs, td.dense_ops) == (
        jd.n_cols, jd.col_height, jd.dense_macs, jd.dense_ops)
    assert thw.blen(th, td, gamma) == jhw.blen(jh, jd, gamma)
    assert _report(thw.dense_baseline(th, td)) == _report(
        jhw.dense_baseline(jh, jd))
    for ts, br in ((0.0, 1.0), (0.742, 0.8), (0.906, 0.73)):
        assert thw.step_cycles_analytic(th, td, gamma, ts, br) == \
            jhw.step_cycles_analytic(jh, jd, gamma, ts, br)
        assert _report(thw.evaluate(th, td, gamma, ts, br)) == _report(
            jhw.evaluate(jh, jd, gamma, ts, br))
    sp = {"temporal_sparsity": 0.715, "balance_ratio": 0.7}
    assert _report(thw.evaluate_from_telemetry(th, td, gamma, sp)) == \
        _report(jhw.evaluate_from_telemetry(jh, jd, gamma, sp))


@pytest.mark.parametrize("fired", [0.05, 0.3, 0.9])
def test_trace_driven_model_equal(fired):
    masks = np.random.default_rng(int(fired * 100)).random(
        (64, jhw.TEST_LAYER.n_cols)) < fired
    for hw in HWS:
        jh, th = getattr(jhw, hw), getattr(thw, hw)
        np.testing.assert_array_equal(
            thw.step_cycles_from_masks(th, thw.TEST_LAYER, 0.9375, masks),
            jhw.step_cycles_from_masks(jh, jhw.TEST_LAYER, 0.9375, masks))
        assert _report(thw.evaluate(th, thw.TEST_LAYER, 0.9375,
                                    delta_masks=masks)) == _report(
            jhw.evaluate(jh, jhw.TEST_LAYER, 0.9375, delta_masks=masks))


def test_table4_ladder_and_comparison_equal():
    ours = {k: _report(v) for k, v in thw.table4_ladder().items()}
    ref = {k: _report(v) for k, v in jhw.table4_ladder().items()}
    assert ours == ref
    custom = dict(ts_by_theta={0.2: 0.8, 0.3: 0.715},
                  br_by_theta={0.3: 0.7})
    assert {k: _report(v) for k, v in thw.table4_ladder(
        gamma=0.94, **custom).items()} == {
        k: _report(v) for k, v in jhw.table4_ladder(gamma=0.94,
                                                    **custom).items()}
    rep_t = thw.table4_ladder()["delta_0.3"]
    rep_j = jhw.table4_ladder()["delta_0.3"]
    assert thw.comparison_table(rep_t, thw.SPARTUS_WALL_POWER_W) == \
        jhw.comparison_table(rep_j, jhw.SPARTUS_WALL_POWER_W)
    assert thw.PRIOR_ACCELERATORS == jhw.PRIOR_ACCELERATORS
    assert thw.EDGE_SPARTUS_WALL_POWER_W == jhw.EDGE_SPARTUS_WALL_POWER_W


@pytest.mark.parametrize("gamma,ts", [(0.9375, 0.906), (0.0, 0.0),
                                      (0.75, 0.5)])
def test_dram_energy_model_equal(gamma, ts):
    n = jhw.TEST_LAYER.dense_macs
    for bits in (8, 16):
        jfm, tfm = jmem.FetchModel(bits, 10, 16), tmem.FetchModel(bits, 10, 16)
        assert tmem.weight_bits_per_frame(n, gamma, ts, tfm) == \
            jmem.weight_bits_per_frame(n, gamma, ts, jfm)
        assert tmem.dense_bits_per_frame(n, tfm) == \
            jmem.dense_bits_per_frame(n, jfm)
        assert tmem.fig14_table(n, gamma, ts, tfm) == jmem.fig14_table(
            n, gamma, ts, jfm)
    assert tmem.DRAM_ENERGY_PJ_PER_BIT == jmem.DRAM_ENERGY_PJ_PER_BIT
    for dram in jmem.DRAM_ENERGY_PJ_PER_BIT:
        assert tmem.energy_per_frame_uj(1e6, dram) == \
            jmem.energy_per_frame_uj(1e6, dram)
