#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout (``BENCHMARK.json`` and ``src/repro_torch``
beside ``bench/``), on a machine with an NVIDIA GPU.  Prints, as the
last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``compared``: each number the correctness
check compared, with its limit (also the last lines of standard error).
Exits non-zero, printing no result, without a card, or if JAX or the
JAX package (``repro``) was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import cell
    from bench.manifest import Manifest

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 4
    chips = Manifest(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    return report(cell.run(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START))


def report(out) -> int:
    """Print a finished run's result, unless JAX or the JAX package was
    loaded in this process by then: by the program, the reference or a
    metric's reader, all of which have run."""
    from bench import cell

    forbidden = cell.loaded_forbidden(sys.modules)
    if forbidden:
        print("loaded in this process: " + ", ".join(forbidden),
              file=sys.stderr)
        return 3
    result = out["result"]
    print("notes " + json.dumps(out["notes"]), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)     # nothing may print after the result's lines
