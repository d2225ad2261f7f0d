"""The traced slice: a fixed number of requests after the measured window,
under torch.profiler, reduced to what the per-layer metrics read.

The benchmark's own spans are ``record_function`` ranges named
``bench.<layer>``, opened and closed by forward hooks on the program's
modules (``hook_ranges``) or around the benchmark's own calls
(``span``). A range's device time is the time of the device operations
launched from inside it: each launch on the host (a runtime or driver
call) and the operation it started share a correlation id in the trace.

What ``profile`` leaves in ``run.slice``:
  window_s       host seconds of the slice, drained at its end
  busy_s         union of device-operation intervals (kernels, copies,
                 fills), seconds
  units          fields or samples the slice completed
  requests       requests in the slice
  ranges         {layer: device seconds launched inside bench.<layer>}
  range_calls    {layer: times the range was entered}
  kernels        {kernel name: [launches, device seconds]}
  breakdown      device_ops and idle_gaps (the result line's breakdown)
  spans          the program's own ``bflow.*`` spans (spans.py:reduce):
                 {name: calls, wall_s, device_s, idle_s}
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterable, List

import torch

from benchmark.harness import scratch_dir

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
PREFIX = "bench."


@contextlib.contextmanager
def hook_ranges(modules: Dict[str, Iterable[torch.nn.Module]]):
    """A ``bench.<layer>`` range around every forward call of each module
    listed under that layer, while the context is open."""
    handles = []
    for layer, mods in modules.items():
        for mod in mods:
            open_ranges: List = []

            def pre(_m, _args, layer=layer, open_ranges=open_ranges):
                rf = torch.profiler.record_function(PREFIX + layer)
                rf.__enter__()
                open_ranges.append(rf)

            def post(_m, _args, _out, open_ranges=open_ranges):
                open_ranges.pop().__exit__(None, None, None)

            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def span(layer: str, on: bool):
    """A ``bench.<layer>`` range around the benchmark's own call (traced
    slice only)."""
    if on:
        return torch.profiler.record_function(PREFIX + layer)
    return contextlib.nullcontext()


def profile(run, cell) -> None:
    """Profile ``trace_requests`` requests; reduce the trace into
    run.slice."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from benchmark import spans

    n = run.workload["trace_requests"]
    cell.drain()
    activities = [ProfilerActivity.CPU]
    if run.device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    units = 0
    with cell.ranges(), torch_profile(activities=activities) as prof:
        cell.tracing = True
        t0 = time.perf_counter()
        for _ in range(n):
            cell.request()
            units += cell.units
        cell.drain()
        wall = time.perf_counter() - t0
        cell.tracing = False
    with scratch_dir() as d:
        path = d / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    run.slice = reduce(events, wall)
    run.slice.update(units=units, requests=n, spans=spans.reduce(events))


def _union(intervals: List[tuple]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(host: List[Dict], starts: List[float], t: float):
    """Name of the shortest host event that spans time t, or None."""
    best = None
    i = bisect.bisect_right(starts, t)
    # host events are sorted by start; look back over those that began
    # before t (bounded: the nesting depth is small)
    for e in reversed(host[max(0, i - 400):i]):
        if e["ts"] + e["dur"] >= t and (best is None
                                         or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best else None


def reduce(events: List[Dict], wall: float) -> Dict:
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(b - a for a, b in merged)

    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    by_corr: Dict[int, float] = defaultdict(float)
    for e in dev:
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += e["dur"] / 1e6
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]

    # device time launched inside each bench.<layer> range (same thread)
    launches = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr in by_corr:
                launches[e.get("tid")].append((e["ts"], corr))
    for lst in launches.values():
        lst.sort()
    ranges: Dict[str, float] = defaultdict(float)
    range_calls: Dict[str, int] = defaultdict(int)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIX)):
            layer = e["name"][len(PREFIX):]
            range_calls[layer] += 1
            lst = launches.get(e.get("tid"), [])
            lo = bisect.bisect_left(lst, (e["ts"], -1))
            hi = bisect.bisect_right(lst, (e["ts"] + e["dur"], float("inf")))
            ranges[layer] += sum(by_corr[c] for _, c in lst[lo:hi]) / 1e6

    # idle gaps between device work, by what the host was doing
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)
    by_host: Dict[str, float] = defaultdict(float)
    for length, mid in gaps[:2000]:
        by_host[_innermost(host, starts, mid) or "(no host op)"] += (
            length / 1e6)
    top_ops = sorted(((n, k[1]) for n, k in kernels.items()),
                     key=lambda x: -x[1])[:10]
    top_gaps = sorted(by_host.items(), key=lambda x: -x[1])[:10]
    return {"window_s": wall, "busy_s": busy_us / 1e6,
            "ranges": dict(ranges), "range_calls": dict(range_calls),
            "kernels": {n: list(k) for n, k in kernels.items()},
            "breakdown": {"device_ops": [[n[:120], s] for n, s in top_ops],
                          "idle_gaps": [[n[:120], s] for n, s in top_gaps]}}
