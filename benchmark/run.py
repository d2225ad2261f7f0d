#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the weights and inputs from the seed, warms up the cell's shapes,
serves requests for ``--seconds``, with ``--trace 1`` profiles a fixed
slice after the window, compares the kept answers with the reference and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics untraced, its
per-layer metrics traced), device and, last, every number compared beside
its limit (also the last lines of standard error). Needs a CUDA device:
without one it exits with code 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    wl = harness.load("workloads", args.workload)
    chips = wl.get("chips", 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    import bflow_tpu_torch

    if ROOT not in Path(bflow_tpu_torch.__file__).resolve().parents:
        print(f"bflow_tpu_torch loaded from {bflow_tpu_torch.__file__}, "
              f"outside the checkout", file=sys.stderr)
        return 2
    run = harness.Run(args.workload, args.seed, args.seconds,
                      bool(args.trace), workload=wl)
    run.started = STARTED
    result = harness.execute(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    harness.report_window(run)
    harness.report_checks(run.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
