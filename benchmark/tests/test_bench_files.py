"""BENCHMARK.json and the benchmark's data files: names, units, the cells
that report each metric, what the benchmark imports, and that a cell is
added by data alone."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, KEPT, ROOT, small

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "bflow_tpu", "chip_smoke", "scripts"}


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [w["name"] for w in SPEC["workloads"]] == list(CELLS)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = harness.load("workloads", cell)
    config = harness.load("configs", wl["config"])
    assert entry["config"] == wl["config"] == config["name"]
    assert entry["why"] == wl["why"] and len(wl["why"]) <= 200
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    assert (ROOT / "benchmark" / "traffic" / f"{wl['kind']}.py").is_file()
    files = {c["name"]: c["file"] for c in SPEC["configs"]}
    assert files[wl["config"]] == f"benchmark/configs/{wl['config']}.json"
    assert config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == wl["config"])


@pytest.mark.parametrize("cell", KEPT)
def test_kept_cell_files_load_and_report_nothing(cell):
    """A kept workload is not listed, and no metric but set-up (every
    cell's) names it; its files still load, so a later PR lists it again
    by entries in BENCHMARK.json alone."""
    assert cell not in {w["name"] for w in SPEC["workloads"]}
    wl = harness.load("workloads", cell)
    assert harness.load("configs", wl["config"])["name"] == wl["config"]
    assert (ROOT / "benchmark" / "traffic" / f"{wl['kind']}.py").is_file()
    assert [m["name"] for m in harness.reported(cell, False, SPEC)] == [
        "setup_s"]
    assert harness.reported(cell, True, SPEC) == []


@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_has_a_reader_and_its_end_to_end_metric(cell):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    one; every per-layer metric it reports moves an end-to-end metric the
    cell reports, and every metric has a reader."""
    e2e = {m["name"] for m in harness.reported(cell, False, SPEC)}
    layer = harness.reported(cell, True, SPEC)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in harness.reported(cell, False, SPEC) + layer:
        assert callable(harness.reader(m["name"]).read)


def test_suffix_names_the_moved_metric():
    suffix = {"latency": "latency_ms_p95", "eval": "fields_per_s",
              "train": "train_samples_per_s"}
    for m in SPEC["per_layer"]:
        assert m["moves"] == suffix[m["name"].rsplit(".", 1)[1]]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_imports():
    bench = ROOT / "benchmark"
    for path in bench.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.relative_to(bench).parts:
            assert "bflow_tpu_torch" not in tops, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    monkeypatch.setitem(sys.modules, "bflow_tpu_torch.fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bflow_tpu.fake", sys)
    assert harness.forbidden_modules() == ["bflow_tpu"]


def test_cell_added_by_data_alone(tmp_path, monkeypatch):
    """A copy of the benchmark's files plus one new cell file (and its
    entries in a BENCHMARK.json): the harness finds and runs it by name,
    no file edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    wl = small("mf_ei.eval_b8")
    wl["why"] = "a later cell"
    (bench / "workloads" / "mf_ei.eval_b2.json").write_text(json.dumps(wl))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "mf_ei.eval_b2", "config": "mf_ei",
                              "traffic": "eval_b2", "chips": 1,
                              "why": "a later cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "mf_ei.eval_b8" in m.get("workloads", ()):
            m["workloads"].append("mf_ei.eval_b2")
    monkeypatch.setattr(harness, "BENCH", bench)
    run = harness.Run("mf_ei.eval_b2", 3, 0.3, False, device="cpu")
    result = harness.execute(run, spec)
    assert result["correct"]
    assert set(result["metrics"]) == {"fields_per_s", "setup_s"}


def test_run_without_a_card_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dsec_ei.latency_b1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_loads_nothing_forbidden():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.');"
         "import benchmark.traffic.stream, benchmark.traffic.eval,"
         "benchmark.traffic.train, benchmark.trace, benchmark.calibrate;"
         "from benchmark import harness; print(harness.forbidden_modules())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
