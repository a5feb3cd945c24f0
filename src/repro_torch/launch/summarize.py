"""Render the dry-run JSON records into tables; port of
``repro/launch/summarize.py``.

    PYTHONPATH=src python -m repro_torch.launch.summarize [--dir build/dryrun]

It reads the reference's records as well as the port's: a record's
memory names its fit against the card it was priced for (``fits_16gb``
for the reference's TPU v5e, ``fits_80gb`` for the H100).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(dir_: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def _fits(memory: Dict) -> bool:
    return next(v for k, v in memory.items() if k.startswith("fits_"))


def dryrun_table(records: List[Dict], mesh: str) -> str:
    rows = [
        "| arch | shape | kind | status | peak GiB | fits | compile s |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "ok":
            m = r["memory"]
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['kind']} | ok | "
                f"{fmt_bytes(m['peak_bytes'])} | "
                f"{'Y' if _fits(m) else 'NO'} | {r.get('compile_s', '')} |"
            )
        else:
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['kind']} | {r['status']} "
                f"| - | - | - |"
            )
    return "\n".join(rows)


def roofline_table(records: List[Dict]) -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | bottleneck |"
        " useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != "single" or "roofline" not in r:
            continue
        rf = r["roofline"]
        dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        frac = rf["compute_s"] / dom if dom > 0 else 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} | "
            f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
            f"{rf['bottleneck']} | {rf['useful_ratio']:.2f} | {frac:.3f} |"
        )
    return "\n".join(rows)


def pick_hillclimb(records: List[Dict]):
    """The hill-climb targets: the worst roofline fraction and the most
    collective-bound cell."""
    cands = [r for r in records if r["mesh"] == "single" and "roofline" in r]

    def frac(r):
        rf = r["roofline"]
        dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        return rf["compute_s"] / dom if dom else 0.0

    def coll_ratio(r):
        rf = r["roofline"]
        return rf["collective_s"] / max(rf["compute_s"], 1e-12)

    worst = min(cands, key=frac)
    coll = max(cands, key=coll_ratio)
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run (single-pod 16x16)\n")
    print(dryrun_table(recs, "single"))
    print("\n## Dry-run (multi-pod 2x16x16)\n")
    print(dryrun_table(recs, "multi"))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(recs))
    try:
        worst, coll = pick_hillclimb(recs)
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']}")
        print(f"most collective-bound:   {coll['arch']}/{coll['shape']}")
    except ValueError:
        pass


if __name__ == "__main__":
    main()
