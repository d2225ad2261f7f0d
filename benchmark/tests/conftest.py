"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, the cells as BENCHMARK.json and the workload files name them, and
the cells cut to a size a CPU test holds (every width as published; 64x80
frames, 2 refinement steps, small pools and event counts)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the listed cells, in BENCHMARK.json's order
CELLS = tuple(w["name"] for w in SPEC["workloads"])
# workloads whose files are kept, and tested here, but that BENCHMARK.json
# does not list (PERF.md, Open questions: why, and what would bring them in)
KEPT = tuple(sorted({p.stem for p in (ROOT / "benchmark" / "workloads")
                     .glob("*.json")} - set(CELLS)))
SMALL = {"height": 64, "width": 80, "iters": 2, "pool": 2,
         "trace_requests": 2}


def of_kind(*kinds: str) -> list:
    """The listed and kept cells whose traffic is one of ``kinds``."""
    return [c for c in CELLS + KEPT
            if harness.load("workloads", c)["kind"] in kinds]


def small(cell: str) -> dict:
    wl = harness.load("workloads", cell)
    wl.update(SMALL)
    if "warmup" in wl:
        wl["warmup"] = 1
    if wl["kind"] == "stream":
        wl.update(events=[2000, 4000], capacity=8192)
    else:
        wl["batch"] = 2
    return wl


def run_small(cell: str, seed: int = 2 ** 31 + 11, trace: bool = False,
              seconds: float = 0.5, spec=None):
    """One run of the cell at the small size on the CPU (the harness's
    look for a card skipped): (result, run)."""
    run = harness.Run(cell, seed, seconds, trace, device="cpu",
                      workload=small(cell))
    return harness.execute(run, spec), run


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
