#!/usr/bin/env python3
"""Find the open-loop mix's knee: the highest arrival rate the port
sustains, run once when the stream cell is defined (its rate then sits
in the mix's file at about four fifths of the knee).  The cell may be
one of ``bench/parked.json``'s.  Sustained: the
admission backlog does not grow over the window and the block latency's
95th percentile stays within ``--limit-ms``.  One process, one model,
each rate with a fresh server.

    python3 bench/sweep.py --workload NAME --rates 30 50 70 --seconds 10
"""
import argparse
import asyncio
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--limit-ms", type=float, default=320.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench import drivers, generator, instrument, program
    from bench.manifest import Manifest

    program.import_port()
    man = Manifest(ROOT)
    parked = json.loads((ROOT / "bench" / "parked.json").read_text())
    man.data["workloads"] += parked["workloads"]
    cell = man.workload(args.workload)
    cfg, base = man.config(cell["config"]), man.traffic(cell["traffic"])
    fam = man.family(cfg["family"])
    dev = torch.device("cuda")
    params = fam.make_params(cfg, args.seed, dev)
    engine = program.pool_engine(params, cfg, fam, dev)
    for rate in args.rates:
        traffic = dict(base, rate_per_s=rate)
        plan = generator.make_plan(traffic, fam.input_dim(cfg), args.seed,
                                   args.seconds)
        srv = program.server(engine, traffic["server"])
        rec = asyncio.run(drivers.open_loop(srv, plan, traffic,
                                            args.seconds,
                                            instrument.NullHooks()))
        lat = np.asarray(rec["latencies"]) * 1e3
        p95 = float(np.percentile(lat, 95)) if lat.size else None
        grew = rec["backlog"]["end"] > rec["backlog"]["start"] + 2
        print(json.dumps({
            "rate_per_s": rate, "blocks": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": p95, "p99_ms": float(np.percentile(lat, 99))
            if lat.size else None,
            "backlog": rec["backlog"], "attempted": rec["attempted"],
            "failed": rec["failed"], "open_late_s": rec["open_late_s"],
            "sustained": bool(p95 is not None and p95 <= args.limit_ms
                              and not grew and rec["failed"] == 0)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
