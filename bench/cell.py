"""One run of one cell: set-up, the measured window, the check of what
the clients held, and the metrics read from the run's record."""
from __future__ import annotations

import asyncio
import gc
import math
import time
from pathlib import Path
from typing import Dict, Optional

from bench import correctness, counting, drivers, generator, instrument
from bench import program
from bench.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None) -> Dict:
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    torch.set_num_threads(1)
    man = Manifest(root)
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    fam = man.family(cfg["family"])
    program.import_port()
    dev = torch.device(device)

    stamps = {"imports": time.perf_counter()}
    params = fam.make_params(cfg, seed, dev)
    stamps["weights"] = time.perf_counter()
    plan = generator.make_plan(traffic, fam.input_dim(cfg), seed, seconds)
    stamps["traffic"] = time.perf_counter()
    spans = instrument.SpanRecorder() if trace else None
    counters = chunks = profile = None
    hooks = instrument.NullHooks()
    if trace:
        counters = instrument.Counters(program.ops_module(),
                                       fam.row_width(cfg), dev)
        counters.install()
        chunks = instrument.ChunkLog(program.pool_engine_class())
        chunks.install()
        profile = instrument.DeviceProfile() if dev.type == "cuda" else None
        if profile is not None:
            profile.prepare()
        hooks = instrument.TracedHooks(counters, profile)
    try:
        paced = traffic["loop"] == "paced"
        engine = (program.batch1_engine if paced
                  else program.pool_engine)(params, cfg, fam, dev)
        stamps["pack"] = time.perf_counter()
        gc.collect()
        gc.freeze()   # set-up's objects stay out of the window's collections
        if paced:
            rec = drivers.paced(engine, plan, traffic, seconds, hooks, dev,
                                spans)
        else:
            srv = program.server(engine, traffic["server"], tracer=spans)
            loop = {"closed": drivers.closed_loop,
                    "open": drivers.open_loop}[traffic["loop"]]
            rec = asyncio.run(loop(srv, plan, traffic, seconds, hooks))
            del srv
        counts = counters.read() if counters is not None else None
    finally:
        for patch in (counters, chunks):
            if patch is not None:
                patch.uninstall()
        gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    compared = correctness.check(rec["finished"], plan,
                                 man.reference(cfg["reference"]), params,
                                 cfg, traffic["sample"], seed, dev)
    rec.update(setup_s=hooks.t0 - t_start, t0=hooks.t0, ta=hooks.ta,
               tb=hooks.tb, t1=hooks.t1, cfg=cfg, family=fam,
               traffic=traffic,
               peaks=counting.PEAKS,
               spans=spans.spans if spans is not None else [],
               chunks=chunks.calls if chunks is not None else [],
               profile=profile.summary() if profile is not None else None,
               counts=counts, setup_stamps=stamps, t_start=t_start)
    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m["name"])(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info(dev, peak, rec["profile"])}
    if trace and rec["profile"] is not None:
        out["breakdown"] = breakdown(rec)
    out["compared"] = compared
    return {"result": out, "notes": notes(rec)}


def notes(rec: Dict) -> Dict:
    """What a reader of the run's log wants beside the result: the
    thirds' rates (how much the counters and the profiler cost), the
    dispatch's host time a frame step in each third, the fired deltas a
    row by layer input width, how late streams opened."""
    marks = [rec["t0"], rec["ta"], rec["tb"], rec["t1"]]
    thirds = list(zip(marks, marks[1:]))
    if rec["profile"] is not None:     # t1 also waits for the trace's read
        thirds[2] = (rec["profile"]["t_on"], rec["profile"]["t_off"])
    stamps = dict(rec["setup_stamps"], window=rec["t0"])
    at, out = rec["t_start"], {"setup_s_by_step": {}}
    for name, t in stamps.items():      # each step's share of set-up
        out["setup_s_by_step"][name] = t - at
        at = t
    if rec.get("deliveries"):
        out["rows_per_s_by_third"] = [
            sum(n for t, n in rec["deliveries"] if a <= t < b) / (b - a)
            for a, b in thirds]
        bins = [0] * int(rec["t1"] - rec["t0"] + 1)
        for t, n in rec["deliveries"]:
            if rec["t0"] <= t < rec["t1"]:
                bins[int(t - rec["t0"])] += n
        out["rows_by_second"] = bins
    if rec["chunks"]:
        per = []
        for a, b in thirds:
            d = sum(y - x for n, x, y in rec["spans"]
                    if n == "dispatch" and a <= x < b)
            steps = sum(n for t, n in rec["chunks"] if a <= t < b)
            per.append(1e6 * d / steps if steps else None)
        out["dispatch_us_per_step_by_third"] = per
    fired = (rec["counts"] or {}).get("fired")
    if fired and fired["rows"]:     # pre-clip, by the encoder's x width
        out["fired_per_row_by_width"] = {
            w: n / fired["rows"] for w, n in fired["by_width"].items()}
    for key in ("open_late_s", "backlog"):
        if key in rec:
            out[key] = rec[key]
    if rec["profile"] is not None:
        out["profiler_start_s"] = rec["profile"]["start_stall_s"]
    return out


def device_info(dev, peak: int, prof) -> Dict:
    import torch

    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def breakdown(rec: Dict) -> Dict:
    prof = rec["profile"]
    ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])
    gaps = instrument.idle_by_span(prof["ops"], rec["spans"],
                                   prof["t_on"], prof["t_off"])
    return {"device_ops": [[name[:120], sec] for name, (_, sec) in ops[:10]],
            "idle_gaps": [[name, sec] for name, sec in gaps[:10]]}
