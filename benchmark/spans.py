#!/usr/bin/env python3
"""The program's spans in a traced slice: the ``bflow.*`` ranges that
bflow_tpu_torch opens itself (utils/timers.py), reduced against the
device activity of the same trace, and the checks that hold the trace to
them.

``reduce(events)`` -> {span name: {calls, wall_s, device_s, idle_s}}, a
step's ``bflow.step#<call>`` under ``step``:
  calls     times the span was entered
  wall_s    its summed durations
  device_s  device time (kernels, copies, fills) of the operations whose
            launch (the CUDA API call that started it, matched by
            correlation id) lies inside one of its intervals, on any
            thread: autograd launches the backward from its own thread,
            not from the one inside ``bflow.backward``. A cell runs one
            request at a time, so a launch inside the interval belongs
            to the span.
  idle_s    its intervals less their overlap with the union of device
            intervals: the device waiting while the host was in the span

``span_ms(run, name, key)``: what the per-layer metrics read from the
traced slice's ``spans`` (benchmark/trace.py keeps ``reduce``'s result
there).

``checks(events)``: what the device ran outside every ``bflow.step``
(kernels apart from copies and fills: only the benchmark's own host
copies belong there), and how many device operations start before their
launch (0 where host and device share one clock).

Run as a script, it serves one cell as ``benchmark/run.py --trace 1``
does (the same window, slice and comparison) and prints run.py's result
line, then one line with ``spans`` per request and ``checks`` of the
traced slice, and the ``bench.*`` hook ranges beside the spans that take
their place:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

``--spans 0`` runs the slice with the program's spans closed (each is a
null context though the profiler runs): the slice's cost of the spans.
"""

import time

STARTED = time.perf_counter()

import bisect  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

PREFIX = "bflow."
# bench.* hook ranges (benchmark/trace.py) and the spans that hold the
# same calls
HOOKS = {"encoder": "encoders", "update": "update", "forward": "forward"}

Interval = Tuple[float, float]


def _overlap(a: List[List[float]], b: List[List[float]]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(merged: List[List[float]], t: float) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _device(events: List[Dict]):
    """(device events, {correlation: device us}, {correlation: launch
    ts})."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS]
    by_corr: Dict[int, float] = defaultdict(float)
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr in by_corr:
                launch[corr] = e["ts"]
    return dev, by_corr, launch


def span_intervals(events: List[Dict]) -> Dict[str, List[Interval]]:
    """{span name: its intervals (us)}, the step's call number dropped."""
    out: Dict[str, List[Interval]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIX)):
            name = e["name"][len(PREFIX):].split("#")[0]
            out[name].append((e["ts"], e["ts"] + e["dur"]))
    return out


def reduce(events: List[Dict]) -> Dict[str, Dict[str, float]]:
    dev, by_corr, launch = _device(events)
    busy = trace._union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    out = {}
    for name, iv in span_intervals(events).items():
        merged = trace._union(iv)
        device = sum(by_corr[c] for c, t in launch.items()
                     if _inside(merged, t))
        wall = sum(b - a for a, b in iv)
        covered = sum(b - a for a, b in merged)
        out[name] = {"calls": len(iv), "wall_s": wall / 1e6,
                     "device_s": device / 1e6,
                     "idle_s": (covered - _overlap(merged, busy)) / 1e6}
    return out


def span_ms(run, name: str, key: str):
    """1e3 x the span's ``key`` (device_s or idle_s) in the traced slice,
    per field, or per step in a training cell (where a request is a
    step); None where the slice holds no such span."""
    span = run.slice.get("spans", {}).get(name)
    per = run.slice.get(
        "requests" if run.workload["kind"] == "train" else "units")
    if span is None or not per:
        return None
    return 1e3 * span[key] / per


def checks(events: List[Dict]) -> Dict[str, float]:
    """outside_kernel_s / outside_copy_s: device time of kernels / of
    copies and fills launched outside every bflow.step (or with no launch
    in the trace); busy_s: the union of device intervals; early_starts:
    device operations that start before their launch event;
    worst_early_us: the earliest of them."""
    dev, _, launch = _device(events)
    steps = trace._union(span_intervals(events).get("step", []))
    out = {"outside_kernel_s": 0.0, "outside_copy_s": 0.0,
           "busy_s": sum(b - a for a, b in trace._union(
               (e["ts"], e["ts"] + e["dur"]) for e in dev)) / 1e6,
           "early_starts": 0, "worst_early_us": 0.0}
    for e in dev:
        t = launch.get((e.get("args") or {}).get("correlation"))
        if t is None or not _inside(steps, t):
            key = ("outside_kernel_s" if e["cat"] == "kernel"
                   else "outside_copy_s")
            out[key] += e["dur"] / 1e6
        if t is not None and e["ts"] < t:
            out["early_starts"] += 1
            out["worst_early_us"] = max(out["worst_early_us"], t - e["ts"])
    return out


def main(argv=None) -> int:
    import argparse
    import json

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    if not args.spans:
        from bflow_tpu_torch.utils import timers

        timers._profiler_enabled = lambda: False
    seen = {}
    whole = trace.reduce

    def reduce_and_check(events, wall):
        seen.update(checks=checks(events))
        return whole(events, wall)

    trace.reduce = reduce_and_check
    run = harness.Run(args.workload, args.seed, args.seconds, True)
    run.started = STARTED
    print(json.dumps(harness.execute(run)), flush=True)
    s = run.slice
    n = s["requests"]
    spans = {k: {"calls": v["calls"] / n,
                 **{m[:-2] + "_ms": 1e3 * v[m] / n
                    for m in ("wall_s", "device_s", "idle_s")}}
             for k, v in s["spans"].items()}
    hooks = {k: [1e3 * s["ranges"][k] / n,
                 spans.get(v, {}).get("device_ms")]
             for k, v in HOOKS.items() if k in s["ranges"]}
    print(json.dumps({
        "spans_per_request": spans, "checks": seen["checks"],
        "hooks_vs_spans_ms": hooks, "units": s["units"], "requests": n,
        "slice_ms_per_request": 1e3 * s["window_s"] / n,
        "window_ms_per_request": 1e3 * run.window_s / run.requests}))
    harness.report_window(run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
