"""Whole runs on the CPU at a small size with the timed path broken
underneath, or with the control (the reference one precision below the
configuration's) in the program's place: ``correct`` has to come out
false."""

import importlib

import torch
import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, KEPT, of_kind, run_small, small
from benchmark.traffic import eval as eval_kind
from benchmark.traffic import stream as stream_kind
from benchmark.traffic import train as train_kind
from benchmark.traffic.base import rel
from bflow_tpu_torch.ops import bezier


@pytest.mark.parametrize("cell", CELLS + KEPT)
def test_sound_run_is_correct(cell):
    result, _ = run_small(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [c for c in of_kind("eval")
                                  if small(c)["precision"] == "float32"])
def test_f32_checks_as_before(cell):
    """An f32 evaluation cell's numbers are those of the judge before it
    judged bf16 cells at their own precision: flow_rel and metric_rel
    only, equal to the last digit (the former loop, written out)."""
    run = harness.Run(cell, 2 ** 31 + 23, 0.3, False, device="cpu",
                      workload=small(cell))
    c = eval_kind.Cell(run)
    harness.serve(run, c)
    c.release()
    flow_worst = metric_worst = 0.0
    for k in sorted({e for e, _ in c.kept.values()}):
        m_ref, p_ref = c.reference(k)
        for m, p in [a for e, a in c.kept.values() if e == k]:
            flow_worst = max(flow_worst, rel(p, p_ref))
            metric_worst = max(metric_worst,
                               abs(m - m_ref) / max(abs(m_ref), 1e-30))
    assert c.judge() == {"flow_rel": flow_worst, "metric_rel": metric_worst}


@pytest.fixture
def altered_answer(monkeypatch):
    """Every flow the program produces moved by one pixel."""
    real = bezier.BezierCurves.flow_at
    monkeypatch.setattr(bezier.BezierCurves, "flow_at",
                        lambda self, times: real(self, times) + 1.0)


@pytest.mark.parametrize("cell", of_kind("stream", "eval"))
def test_altered_answer_fails(cell, altered_answer):
    result, _ = run_small(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", of_kind("eval"))
def test_half_batch_fails(cell, monkeypatch):
    """The step sees half the batch: its metrics are the mean over that
    half, the rest of the prediction is left at zero."""
    real = eval_kind.make_eval_step

    def broken(model, task):
        step = real(model, task)

        def half(batch):
            n = batch["ev_repr"].shape[0] // 2
            metrics, pred, low = step(train_kind._half(batch, n))
            return metrics, torch.cat([pred, torch.zeros_like(pred)]), low

        return half

    monkeypatch.setattr(eval_kind, "make_eval_step", broken)
    result, _ = run_small(cell)
    assert not result["correct"], result["checks"]


def test_training_state_unchanged_fails(monkeypatch):
    """The step computes loss and gradients but leaves the weights as
    they were."""
    real = train_kind.make_train_step

    def broken(model, task, opt, sched):
        step = real(model, task, opt, sched)

        def same(batch):
            before = [p.detach().clone() for p in model.parameters()]
            out = step(batch)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return out

        return same

    monkeypatch.setattr(train_kind, "make_train_step", broken)
    result, _ = run_small("mf_ei.train_b3")
    assert not result["correct"], result["checks"]
    assert result["checks"]["change_leaf"]["value"] == 1.0


def test_training_half_batch_fails(monkeypatch):
    """Half of every batch left out, the loss the mean over the rest."""
    real = train_kind.make_train_step

    def broken(model, task, opt, sched):
        step = real(model, task, opt, sched)
        return lambda batch: step(train_kind._half(batch, 1))

    monkeypatch.setattr(train_kind, "make_train_step", broken)
    result, _ = run_small("mf_ei.train_b3")
    assert not result["correct"], result["checks"]


def test_sound_voxel_grid_within_limit():
    """The bf16 cell's grid is f32 whatever the model's precision: a sound
    run's grid is within its limit on the CPU too."""
    result, _ = run_small("dsec_ei.latency_b1")
    check = result["checks"]["grid_rel"]
    assert check["value"] <= check["limit"], check


def test_dropped_events_fail(monkeypatch):
    """The device voxelizer leaves out the last 1% of a window's events."""
    real = stream_kind.window_grid

    def dropping(x, y, p, t, valid, t0, t1, **kw):
        n = int(valid.sum())
        valid = valid & (torch.arange(valid.numel()) < n - n // 100)
        return real(x, y, p, t, valid, t0, t1, **kw)

    monkeypatch.setattr(stream_kind, "window_grid", dropping)
    result, _ = run_small("dsec_ei.latency_b1")
    assert not result["correct"], result["checks"]
    check = result["checks"]["grid_rel"]
    assert check["value"] > check["limit"], check


@pytest.mark.parametrize("cell", CELLS + KEPT)
def test_control_exceeds_a_limit(cell, monkeypatch):
    """The reference at the cell's control rounding (fp8 for bf16, TF32
    for f32) put in the program's place: the harness's own comparison
    finds it not correct."""
    wl = small(cell)
    cls = importlib.import_module(f"benchmark.traffic.{wl['kind']}").Cell
    real = cls.judge
    monkeypatch.setattr(
        cls, "judge",
        lambda self, stand_in=None: real(self, {"rounding": wl["control"]}))
    result, _ = run_small(cell, seed=2 ** 31 + 5, seconds=0.3)
    assert not result["correct"], result["checks"]
