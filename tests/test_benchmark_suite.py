"""The port's benchmark (benchmark/) has CPU tests of its own under
benchmark/tests/: the reference against the port, the fault and control
runs of every cell, the readers and counts, the forbidden-import check.
They run here in a subprocess of their own: collected in this process
they would see the JAX modules other test files load, which the
benchmark's own check forbids. Their card-only cases (marker ``cuda``)
are left out; the subprocess keeps two intra-op threads, beside the
other test workers."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 900


def test_benchmark_cpu_suite_passes():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-m",
         "not cuda", "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    tail = (proc.stdout + proc.stderr)[-6000:]
    assert proc.returncode == 0, tail
    summary = proc.stdout.strip().splitlines()[-1]
    assert " passed" in summary and "failed" not in summary, tail
