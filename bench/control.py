#!/usr/bin/env python3
"""The correctness check's control: the reference put in the program's
place, one precision step below what the configuration states (TF32
for fp32, int4 weights for int8), judged by the same comparison as a
run, on the cell's own sizes and traffic.  Each seed's reading is the
upper end a cell's ``logit_gap`` limit is set under.

    python3 bench/control.py --workload NAME --seeds 1 2 3 [--seconds S]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"fp32": "tf32", "int8": "int4"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench import correctness, generator
    from bench.manifest import Manifest

    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    cfg, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    fam, ref = man.family(cfg["family"]), man.reference(cfg["reference"])
    seconds = args.seconds or man.data["run_seconds"]
    if not torch.cuda.is_available():
        print("needs a CUDA device (the cell's own sizes)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    control = CONTROL[cfg["precision"]]
    for seed in args.seeds:
        t = time.perf_counter()
        params = fam.make_params(cfg, seed, dev)
        plan = generator.make_plan(traffic, fam.input_dim(cfg), seed, seconds)
        done = [(i, f) for i, f in enumerate(plan.feats)]
        pick = correctness.pick(done, traffic["sample"], seed)
        feats = [plan.feats[done[i][0]] for i in pick]
        want = correctness.reference_logits(ref, params, cfg, feats, dev)
        got = correctness.reference_logits(ref, params, cfg, feats, dev,
                                           control)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": control,
            "logit_gap": correctness.logit_gap(got, want),
            "limit": cfg["limits"]["logit_gap"], "rows": sum(
                f.shape[0] for f in feats),
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
