#!/usr/bin/env python3
"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--seconds 2]

For every seed, in one process: the cell's set-up from that seed, a short
window at the cell's own load, then the comparison, printed as one JSON
line ``{"mode": "program", "seed": ..., <number>: <reading>}``:
- program: the program's kept answers against the reference;
- control: the reference at the cell's ``control`` rounding (one
  precision below the configuration's) in the program's place;
- fault (training): the reference with every batch's second half left
  out in the program's place.
The last line gives, per number, the largest program reading and the
smallest control and fault readings. Needs a CUDA device: without one it
exits with code 2.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    wl = harness.load("workloads", args.workload)
    kind = importlib.import_module(f"benchmark.traffic.{wl['kind']}")
    plan = ([("program", s, None) for s in args.seeds]
            + [("control", s, {"rounding": wl["control"]})
               for s in args.control_seeds]
            + [("fault_half", s, {"half": True}) for s in args.fault_seeds])
    readings = {}
    for mode, seed, stand_in in plan:
        run = harness.Run(args.workload, seed, args.seconds, False,
                          workload=wl)
        cell = kind.Cell(run)
        harness.serve(run, cell)
        cell.release()
        values = cell.judge(stand_in)
        print(json.dumps({"mode": mode, "seed": seed, **values,
                          "requests": run.requests,
                          "counts": run.counts}), flush=True)
        for k, v in values.items():
            readings.setdefault(mode, {}).setdefault(k, []).append(v)
        del cell
    summary = {mode: {k: (max(v) if mode == "program" else min(v))
                      for k, v in by.items()}
               for mode, by in readings.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
