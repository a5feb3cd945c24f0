"""The one traffic generator: a mix's parameter file and a seed -> a plan.

A plan holds the utterances (host float32 ``[T, D]`` frames, what a
client would capture) and when they are sent.  Lengths and arrival gaps
are stratified draws (the law's quantiles at ``(i + 0.5) / n``) put in an
order drawn from the seed: every seed sends the same set of sizes and
gaps, in another order, so runs differ in content and order but not in
the amount of work.  Features come from ``features.py``.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np

from bench import features


@dataclasses.dataclass
class Plan:
    feats: List[np.ndarray]            # utterance frames [T_i, D]
    order: np.ndarray                  # utterance ids in sending order
    arrivals: Optional[np.ndarray] = None   # open loop: offsets in s

    @property
    def lengths(self) -> np.ndarray:
        return np.array([f.shape[0] for f in self.feats])


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent streams of one seed (any integer, 64 bits or more)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def stratified_lengths(n: int, law: dict, rng: np.random.Generator
                       ) -> np.ndarray:
    """``n`` lognormal lengths (median, sigma), clipped to [min, max],
    drawn at the law's quantiles and shuffled."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.exp(math.log(law["median"]) + law["sigma"] * z)
    lens = np.clip(np.rint(lens), law["min"], law["max"]).astype(np.int64)
    return rng.permutation(lens)


def stratified_gaps(n: int, rate: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """``n`` exponential inter-arrival gaps of mean ``1/rate`` (a Poisson
    process), drawn at the law's quantiles and shuffled."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)


def burst_gate(times: np.ndarray, burst: Optional[dict]) -> np.ndarray:
    """Which arrivals an on/off burst pattern keeps (all without one):
    ``on_s`` seconds of arrivals, then ``off_s`` with none."""
    if not burst:
        return np.ones(times.shape, bool)
    period = burst["on_s"] + burst["off_s"]
    return (times % period) < burst["on_s"]


def n_utterances(traffic: dict, seconds: float) -> int:
    loop = traffic["loop"]
    if loop == "open":
        span = traffic["ramp_s"] + seconds
        return int(math.ceil(traffic["rate_per_s"] * span * 1.1)) + 8
    if loop == "paced":
        span = traffic["warmup_s"] + seconds
        frames = span * 1000.0 / traffic["frame_ms"]
        return int(math.ceil(frames / traffic["lengths"]["min"])) + 1
    return int(traffic["utterances"])


def make_plan(traffic: dict, input_dim: int, seed: int,
              seconds: float) -> Plan:
    n = n_utterances(traffic, seconds)
    lens = stratified_lengths(n, traffic["lengths"], rng_for(seed, 1))
    feats = features.make(traffic["features"], lens, input_dim,
                          rng_for(seed, 2))
    order = rng_for(seed, 3).permutation(n)
    arrivals = None
    if traffic["loop"] == "open":
        gaps = stratified_gaps(n, traffic["rate_per_s"], rng_for(seed, 4))
        times = np.cumsum(gaps) - gaps[0]
        times = times[burst_gate(times, traffic.get("burst"))]
        span = traffic["ramp_s"] + seconds
        arrivals = times[times < span]
    return Plan(feats=feats, order=order, arrivals=arrivals)
