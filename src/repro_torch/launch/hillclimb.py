"""Perf hill-climb runner: one (arch x shape) cell of the dry run under a
named ``PerfVariant``, recorded beside the baseline; port of
``repro/launch/hillclimb.py``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch granite-34b --shape train_4k --variant fsdp_sp

Artifacts: build/perf/{arch}__{shape}__{variant}.json
"""
import argparse
import json
import os

from repro_torch import perf
from repro_torch.launch import dryrun

VARIANTS = {
    "baseline": perf.PerfVariant(name="baseline"),
    # decode: gather-free attention over the seq-sharded KV cache
    "gathered_kv": perf.PerfVariant(name="gathered_kv",
                                    seq_sharded_decode=False),
    # train: drop TP, 2-axis FSDP + sequence parallelism
    "fsdp_sp": perf.PerfVariant(name="fsdp_sp", fsdp_sp=True),
    # train: fsdp_sp with more microbatches (activation/collective trade)
    "fsdp_sp_mb8": perf.PerfVariant(name="fsdp_sp_mb8", fsdp_sp=True,
                                    microbatches=8),
    # train: same 256 devices, wider data axis
    "tp8": perf.PerfVariant(name="tp8",
                            mesh_override=((32, 8), ("data", "model"))),
    "tp4": perf.PerfVariant(name="tp4",
                            mesh_override=((64, 4), ("data", "model"))),
    # pure DP + 256-way FSDP: no model axis at all
    "tp1": perf.PerfVariant(name="tp1",
                            mesh_override=((256, 1), ("data", "model"))),
    # serving quantization
    "int8_weights": perf.PerfVariant(name="int8_weights", int8_weights=True),
}

OUT = os.path.join(os.path.dirname(__file__), "../../../build/perf")


def run(arch: str, shape: str, variant_name: str, multi_pod: bool = False):
    """The cell's dry-run record under ``variant_name``, written to
    ``OUT``.  A variant's microbatch count reaches the step through
    ``REPRO_MICROBATCHES`` (``steps.pick_microbatches``), restored after."""
    v = VARIANTS[variant_name]
    out_dir = os.path.abspath(OUT)
    prev = os.environ.pop("REPRO_MICROBATCHES", None)
    if v.microbatches:
        os.environ["REPRO_MICROBATCHES"] = str(v.microbatches)
    try:
        with perf.variant(v):
            rec = dryrun.run_cell(arch, shape, multi_pod, out_dir=out_dir)
    finally:
        os.environ.pop("REPRO_MICROBATCHES", None)
        if prev is not None:
            os.environ["REPRO_MICROBATCHES"] = prev
    rec["variant"] = variant_name
    path = os.path.join(out_dir, f"{arch}__{shape}__{variant_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    rec = run(args.arch, args.shape, args.variant)
    if "roofline" in rec:
        r = rec["roofline"]
        print(f"{args.variant}: compute={r['compute_s']:.3f}s "
              f"mem={r['memory_s']:.3f}s coll={r['collective_s']:.3f}s "
              f"-> {r['bottleneck']}")


if __name__ == "__main__":
    main()
