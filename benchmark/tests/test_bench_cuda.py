"""On the card: one short run of every cell through the command, which
has to print a correct result line."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import CELLS, KEPT, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + KEPT)
def test_cell_runs_correct_on_the_card(cell, cuda):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
