"""One run of one benchmark cell: set-up, the measured window, the traced
slice, the comparison with the reference, and the result line.

Everything that belongs to one cell, configuration, traffic kind or
metric is found by name:

  workloads/<cell>.json    the cell's traffic: config, kind, sizes, pool,
                           the limits of its comparison
  configs/<config>.json    the model configuration as it is run
  traffic/<kind>.py        ``Cell``: builds the program and its inputs from
                           the seed, serves one request, judges the kept
                           answers against the reference
  metrics/<metric>.py      ``read(run)`` -> value or None (the metric's
                           own file, else the file of its name up to the
                           first dot)

and BENCHMARK.json says which metrics a cell reports.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bflow_tpu", "chip_smoke", "scripts")


def load(kind: str, name: str) -> Dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reported(cell: str, trace: bool, spec: Optional[Dict] = None
             ) -> List[Dict]:
    """The metrics BENCHMARK.json has this cell report: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in those cells."""
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The metric's reader module: metrics/<name>.py, else the file of
    its name up to the first dot (one reader for .latency, .eval ...)."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"benchmark.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r}")


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation (numpy's default)."""
    s = sorted(values)
    if not s:
        return math.nan
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", workload: Optional[Dict] = None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.workload = workload or load("workloads", cell)
        self.config = load("configs", self.workload["config"])
        self.started = time.perf_counter()
        self.setup_s = math.nan
        self.latencies: List[float] = []  # seconds, inf for a failure
        self.requests = 0
        self.failed = 0
        self.window_s = math.nan
        self.units = 0  # fields or samples completed in the window
        self.slice: Dict = {}  # the traced slice (trace.py)
        self.counts: Dict = {}  # flops, lookup bytes (the cell's judge)
        self.checks: Dict[str, Dict[str, float]] = {}
        self.memory_peak = 0


def serve(run: Run, cell) -> None:
    """The measured window: one client, back to back, for run.seconds;
    then the device drained. A request that raises counts as failed."""
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        ts = time.perf_counter()
        if ts >= end:
            break
        try:
            cell.request()
            run.latencies.append(time.perf_counter() - ts)
            run.units += cell.units
        except RuntimeError as exc:  # the answer never comes
            print(f"request {run.requests} failed: {exc}", file=sys.stderr)
            run.failed += 1
            run.latencies.append(math.inf)
        run.requests += 1
    cell.drain()
    run.window_s = time.perf_counter() - t0


def judge(run: Run, cell) -> bool:
    """The comparison with the reference; every number beside its limit."""
    limits = run.workload["limits"]
    values = cell.judge()
    run.checks = {k: {"value": values[k], "limit": limits[k]}
                  for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in run.checks.values())
    return ok and run.failed == 0 and run.requests > 0


def metrics(run: Run, spec: Optional[Dict] = None) -> Dict[str, Dict]:
    out = {}
    for m in reported(run.cell, run.trace, spec):
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(run: Run) -> Dict:
    import torch

    rec = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if run.device.startswith("cuda") else "cpu"),
           "count": run.workload.get("chips", 1),
           "memory_peak_bytes": run.memory_peak}
    if run.trace and run.slice:
        rec["busy_s"] = run.slice["busy_s"]
        rec["window_s"] = run.slice["window_s"]
    return rec


def execute(run: Run, spec: Optional[Dict] = None) -> Dict:
    """One whole run; returns the result object (not printed)."""
    import torch

    from benchmark import trace as tracing

    kind = importlib.import_module(
        f"benchmark.traffic.{run.workload['kind']}")
    cell = kind.Cell(run)
    run.setup_s = time.perf_counter() - run.started
    serve(run, cell)
    if run.trace:
        tracing.profile(run, cell)
    if run.device.startswith("cuda"):
        run.memory_peak = torch.cuda.max_memory_allocated()
    cell.release()
    correct = judge(run, cell)
    if run.trace:
        run.counts["flops"] = cell.flops()
    result = {"correct": correct, "attempted": run.requests,
              "failed": run.failed, "metrics": metrics(run, spec),
              "device": device_record(run)}
    if run.trace and run.slice.get("breakdown"):
        result["breakdown"] = run.slice["breakdown"]
    result["checks"] = run.checks
    return result


@contextlib.contextmanager
def scratch_dir():
    """A directory under TMPDIR (the run's own), removed after."""
    with tempfile.TemporaryDirectory(prefix="bench-") as d:
        yield Path(d)


def report_window(run: Run) -> None:
    """The window's request times (ms) and set-up, on standard error."""
    ms = [v * 1e3 for v in run.latencies]
    q = {p: percentile(ms, p) for p in (0, 50, 95, 99, 100)}
    print(f"window: {run.requests} requests in {run.window_s:.3f} s, "
          f"ms min/p50/p95/p99/max {q[0]:.2f}/{q[50]:.2f}/{q[95]:.2f}/"
          f"{q[99]:.2f}/{q[100]:.2f}; setup {run.setup_s:.2f} s",
          file=sys.stderr)


def report_checks(checks: Dict[str, Dict[str, float]]) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def cache_dirs() -> None:
    """Bytecode inside the checkout, at a fixed path: the run after a
    checkout's first finds it written. (The port's kernels build into its
    own ``bflow_tpu_torch/build/``, inside the checkout too.)"""
    sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False
