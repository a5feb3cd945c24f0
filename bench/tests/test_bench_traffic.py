"""The traffic generator: its length law, its arrivals, determinism per
seed, and how sparse the deltas of its features are."""
import json
import math

import numpy as np
import pytest

from bench import generator
from bench.tests.conftest import ROOT


def mix(name):
    return json.loads((ROOT / f"bench/traffic/{name}.json").read_text())


def fire_share(x: np.ndarray, theta: float) -> float:
    """Share of a DeltaLSTM input's deltas that fire (eqs. 4-5)."""
    ref = np.zeros(x.shape[1], np.float32)
    fired = 0
    for frame in x:
        hit = np.abs(frame - ref) > theta
        fired += int(hit.sum())
        ref = np.where(hit, frame, ref)
    return fired / x.size


def test_length_law():
    law = mix("bulk")["lengths"]
    lens = generator.stratified_lengths(4000, law, generator.rng_for(3, 1))
    assert lens.min() >= 90 and lens.max() <= 780
    assert abs(np.median(lens) - 300) <= 2
    inner = lens[(lens > 90) & (lens < 780)]
    assert abs(np.std(np.log(inner)) - 0.4) < 0.03
    # every seed sends the same set of sizes, in another order
    other = generator.stratified_lengths(4000, law, generator.rng_for(4, 1))
    assert sorted(lens) == sorted(other) and list(lens) != list(other)


@pytest.mark.parametrize("name",
                         ["bulk", "noise-bulk", "stream", "batch1"])
def test_plan_is_a_function_of_the_seed(name):
    seed = 2 ** 33 + 17
    a = generator.make_plan(mix(name), 123, seed, 2.0)
    b = generator.make_plan(mix(name), 123, seed, 2.0)
    c = generator.make_plan(mix(name), 123, seed + 1, 2.0)
    assert all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))
    assert np.array_equal(a.order, b.order)
    assert not np.array_equal(a.feats[0][:10], c.feats[0][:10])
    assert all(f.dtype == np.float32 and f.shape[1] == 123 for f in a.feats)
    if a.arrivals is not None:
        assert np.array_equal(a.arrivals, b.arrivals)


def test_open_loop_arrivals_are_poisson_at_the_rate():
    t = dict(mix("stream"), rate_per_s=50.0, ramp_s=5)
    plan = generator.make_plan(t, 123, 9, 60.0)
    gaps = np.diff(plan.arrivals)
    assert abs(len(plan.arrivals) / 65.0 - 50.0) < 2.5
    assert abs(gaps.mean() - 0.02) < 0.002
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1   # exponential


def test_bursts_gate_arrivals():
    t = dict(mix("stream"), rate_per_s=50.0, ramp_s=0,
             burst={"on_s": 1.0, "off_s": 1.0})
    plan = generator.make_plan(t, 123, 9, 20.0)
    assert (plan.arrivals % 2.0 < 1.0).all()


def test_speech_deltas_are_sparse_and_noise_is_not():
    t = mix("bulk")
    plan = generator.make_plan(dict(t, utterances=16), 123, 5, 1.0)
    share = np.mean([fire_share(f, 0.3) for f in plan.feats])
    assert 0.05 < share < 0.25, share
    noise = dict(mix("noise-bulk"), utterances=4)
    plan = generator.make_plan(noise, 123, 5, 1.0)
    assert np.mean([fire_share(f, 0.3) for f in plan.feats]) > 0.6


def test_enough_utterances_for_the_window():
    for name in ("stream", "batch1"):
        t = mix(name)
        n = generator.n_utterances(t, 30.0)
        if t["loop"] == "open":
            assert n >= t["rate_per_s"] * (t["ramp_s"] + 30.0)
        else:
            frames = (t["warmup_s"] + 30.0) * 1000 / t["frame_ms"]
            assert n * t["lengths"]["min"] >= frames
    assert math.isfinite(generator.n_utterances(mix("bulk"), 30.0))
