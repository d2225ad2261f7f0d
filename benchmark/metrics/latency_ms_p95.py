"""latency_ms_p95: the 95th percentile, over every request of the window,
of its time from start (inputs in host memory) to its answer in host
memory; a failed request counts as missing (no value)."""

import math

from benchmark.harness import percentile


def read(run):
    v = percentile(run.latencies, 95) * 1e3
    return v if math.isfinite(v) else None
