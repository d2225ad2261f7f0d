"""Large host buffers reused (bflow_tpu_torch/utils/host_memory.py): after
``reuse_large_host_buffers`` a host tensor the size of a DSEC B=16
prediction, allocated and freed batch after batch, stops faulting its
pages in anew; the eval step sets it for a model on the GPU and leaves a
CPU process's malloc as it was.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bflow_tpu_torch.train import TaskConfig, step as step_module
from bflow_tpu_torch.utils import host_memory

ROOT = Path(__file__).resolve().parents[1]
GLIBC = platform.libc_ver()[0] == "glibc"

# a fresh process: the thresholds are the process's, and its heap is new
FAULTS = """
import json, resource, sys, torch
from bflow_tpu_torch.utils.host_memory import reuse_large_host_buffers
took = reuse_large_host_buffers() if sys.argv[1] == "1" else None
src = torch.randn(16, 480, 640, 2)  # a DSEC B=16 prediction, 39.3 MB
faults = []
for _ in range(40):
    f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    x = src.clone()
    faults.append(resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0)
    del x
print(json.dumps({"took": took, "again": reuse_large_host_buffers(),
                  "faults": faults, "pages": src.numel() * 4 // 4096}))
"""


def _faults(reuse: bool):
    proc = subprocess.run(
        [sys.executable, "-c", FAULTS, "1" if reuse else "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


@pytest.mark.skipif(not GLIBC, reason="the thresholds are glibc's")
def test_reused_buffer_faults_no_pages_in():
    """With the thresholds set, the last twenty of forty 39.3 MB clones
    fault under 1% of their pages in (the first reuse comes after up to
    nine clones: an aligned request takes a little more than the chunk
    the last one freed); glibc took both settings, and took them again on
    a second call."""
    got = _faults(True)
    assert got["took"] is True and got["again"] is True
    assert all(f < got["pages"] // 100 for f in got["faults"][-20:]), got


def test_eval_step_sets_it_for_a_model_on_the_gpu(monkeypatch):
    """make_eval_step calls reuse_large_host_buffers once for a model whose
    parameters are on the GPU, and not for one on the CPU."""
    calls = []
    monkeypatch.setattr(step_module, "reuse_large_host_buffers",
                        lambda: calls.append(1) or True)

    class Model:
        config = SimpleNamespace()

        def __init__(self, cuda):
            self.cuda = cuda

        def parameters(self):
            yield SimpleNamespace(is_cuda=self.cuda)

    step_module.make_eval_step(Model(False), TaskConfig("dsec"),
                               over_ranks=False)
    assert calls == []
    step_module.make_eval_step(Model(True), TaskConfig("dsec"),
                               over_ranks=False)
    assert calls == [1]


def test_off_glibc_it_does_nothing(monkeypatch):
    """Where the C library is not glibc, mallopt's parameters mean nothing
    known: no call is made and the answer is False."""
    monkeypatch.setattr(host_memory.platform, "libc_ver",
                        lambda: ("", ""))
    monkeypatch.setattr(host_memory.ctypes, "CDLL",
                        lambda *a: pytest.fail("mallopt looked up"))
    assert host_memory.reuse_large_host_buffers() is False
