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
from benchmark.tests.conftest import CELLS, KEPT, ROOT, SPEC, run_small, small
from benchmark.traffic import eval as eval_kind
from bflow_tpu_torch.ops import bezier

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
    configs = {c["name"]: c["file"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}", w
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json"
                ).is_file(), w
        assert (ROOT / configs[w["config"]]).is_file(), w
    assert set(configs) == {w["config"] for w in SPEC["workloads"]}
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


BF16_CELL = "dsec_ei_bf16.eval_b16"


def _add_bf16_cell(tmp_path, monkeypatch):
    """A copy of the benchmark's files with a bf16 evaluation cell of a new
    configuration added as new files and BENCHMARK.json entries: the DSEC
    events+frames model with the hand-written conv kernels switched on
    (``pallas_conv``, ``pallas_stem``; their plain versions on the CPU), at
    B=16 bf16 (run here at the small size). Its limit, flow_vs_bf16 4.0,
    is set from the CPU at the small size: sound runs read 1.00-1.71, the
    fp8 control 8.76-12.5 (24 seeds each, 2 entries a seed). Returns the
    spec with the entries."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = harness.load("configs", "dsec_ei")
    config["name"] = "dsec_ei_bf16"
    config["precision"] = "bfloat16"
    config["model"].update(pallas_conv=True, pallas_stem=True,
                           corr_precision="bfloat16",
                           compute_dtype="bfloat16")
    (bench / "configs" / "dsec_ei_bf16.json").write_text(json.dumps(config))
    wl = harness.load("workloads", "dsec_ei.eval_b8")
    wl.update(config="dsec_ei_bf16", precision="bfloat16", batch=16,
              control="fp8", why="DSEC evaluation at bf16 with the conv "
              "kernels", limits={"flow_vs_bf16": 4.0})
    (bench / "workloads" / f"{BF16_CELL}.json").write_text(json.dumps(wl))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({
        "name": "dsec_ei_bf16", "source": config["source"],
        "file": "benchmark/configs/dsec_ei_bf16.json", "reduced": [],
        "why": "DSEC events+frames at bf16 with the conv kernels"})
    spec["workloads"].append({"name": BF16_CELL, "config": "dsec_ei_bf16",
                              "traffic": "eval_b16", "chips": 1,
                              "why": wl["why"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dsec_ei.eval_b8" in m.get("workloads", ()):
            m["workloads"].append(BF16_CELL)
    monkeypatch.setattr(harness, "BENCH", bench)
    return spec


@pytest.mark.parametrize("fault", [None, "control", "altered"])
def test_bf16_cell_added_by_data_alone(fault, tmp_path, monkeypatch):
    """The bf16 cell of a new configuration, added by data alone, runs
    correct at its own precision (the kept flows over the bf16-operand
    reference's gap); the fp8 control in the program's place, or every
    flow moved by 1 px, comes out not correct. No file of the copy is
    edited."""
    spec = _add_bf16_cell(tmp_path, monkeypatch)
    if fault == "control":
        real = eval_kind.Cell.judge
        monkeypatch.setattr(
            eval_kind.Cell, "judge",
            lambda self, stand_in=None: real(self, {"rounding": "fp8"}))
    elif fault == "altered":
        flow_at = bezier.BezierCurves.flow_at
        monkeypatch.setattr(bezier.BezierCurves, "flow_at",
                            lambda self, times: flow_at(self, times) + 1.0)
    result, run = run_small(BF16_CELL, spec=spec)
    assert run.config["model"]["pallas_conv"]
    assert result["correct"] == (fault is None), result["checks"]
    assert set(result["checks"]) == {"flow_vs_bf16"}
    assert set(result["metrics"]) == {"fields_per_s", "setup_s"}
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = tmp_path / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


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
