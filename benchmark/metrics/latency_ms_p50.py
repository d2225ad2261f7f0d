"""latency_ms_p50: the median of the same requests as latency_ms_p95."""

import math

from benchmark.harness import percentile


def read(run):
    v = percentile(run.latencies, 50) * 1e3
    return v if math.isfinite(v) else None
