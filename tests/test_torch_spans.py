"""The program's spans (bflow_tpu_torch/utils/timers.py): the eval step
and the train step, run under torch.profiler on the CPU, leave the eight
``bflow.*`` spans in the exported trace, nested in time inside their
``bflow.step#<call>``; with no profiler running, ``span`` hands out the
shared null context and records nothing.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bflow_tpu_torch as bt
from bflow_tpu_torch.train import (
    TaskConfig,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from bflow_tpu_torch.kernels import conv3x3, conv_common, stem_conv
from bflow_tpu_torch.utils import timers
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ITERS = 2
CONFIGS = {
    "dsec": dict(nbins_context=5, nbins_correlation=5,
                 ev_target_indices=(1, 2, 3, 4), ev_levels=(1, 1, 1, 2),
                 use_images=True, iters_train=ITERS, iters_test=ITERS,
                 lookup_method="gather"),
    "multiflow2d": dict(nbins_context=11, nbins_correlation=7,
                        bezier_degree=4, ev_target_indices=(2, 4, 6, 8, 10),
                        ev_levels=(1, 1, 1, 1, 2), use_images=False,
                        iters_train=ITERS, iters_test=ITERS,
                        lookup_method="gather"),
}
TIMES = (0.5, 1.0)
TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1, "lr_scheduler": {"use": False}}
FORWARD = ("forward", "encoders", "corr", "update")
EIGHT = {"step", *FORWARD, "loss", "backward", "optimizer"}
EPS_US = 1e-3  # the trace's microsecond floats


def _setup(family, remat=False, kernel_path=False):
    cfg = bt.RaftSplineConfig(**CONFIGS[family], remat_updates=remat,
                              **(KERNEL_PATH if kernel_path else {}))
    model = bt.build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    n, h, w = 1, 32, 32
    batch = {"ev_repr": rng.standard_normal(
        (n, h, w, cfg.nbins_total)).astype(np.float32)}
    if family == "dsec":
        task = TaskConfig("dsec")
        batch["img"] = rng.integers(0, 255, (2, n, h, w, 3)).astype(
            np.float32)
        batch["flow"] = rng.standard_normal((n, h, w, 2)).astype(np.float32)
        batch["flow_valid"] = rng.random((n, h, w)) < 0.8
    else:
        task = TaskConfig("multiflow2d", multi_loss=True,
                          supervision_timestamps=TIMES)
        batch["flow"] = rng.standard_normal(
            (len(TIMES), n, h, w, 2)).astype(np.float32)
    return model, task, {k: torch.from_numpy(v) for k, v in batch.items()}


def _spans(prof, tmp_path):
    """The trace's bflow.* ranges: (name after the prefix, start, end)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return sorted(((e["name"][len(timers.PREFIX):], e["ts"],
                    e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(timers.PREFIX)),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] - EPS_US <= inner[1] and inner[2] <= outer[2] + EPS_US


def _by_step(spans):
    """(the step spans, a Counter of the spans inside each); fails on a
    span outside every step."""
    steps = [s for s in spans if s[0].startswith("step#")]
    counts = [Counter() for _ in steps]
    for s in spans:
        if s[0].startswith("step#"):
            continue
        owners = [i for i, st in enumerate(steps) if _inside(s, st)]
        assert len(owners) == 1, f"{s} is inside {len(owners)} steps"
        counts[owners[0]][s[0]] += 1
    return steps, counts


@pytest.mark.parametrize("family,remat", [("dsec", False),
                                          ("multiflow2d", False),
                                          ("dsec", True)])
def test_step_spans_nest_inside_their_step(family, remat, tmp_path):
    """Two eval steps, then two train steps: the eight names, each phase
    in its step, the forward's phases inside the forward, the loss and
    the backward after it, and the steps numbered from 0 per step
    function."""
    model, task, batch = _setup(family, remat)
    eval_step = make_eval_step(model, task)
    opt, sched = build_optimizer(TRAINING, model.parameters())
    train_step = make_train_step(model, task, opt, sched)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            eval_step(batch)
        for _ in range(2):
            train_step(batch)
    spans = _spans(prof, tmp_path)
    assert {s[0].split("#")[0] for s in spans} == EIGHT
    steps, counts = _by_step(spans)
    assert [s[0] for s in steps] == ["step#0", "step#1"] * 2
    per_forward = {"forward": 1, "encoders": 1, "corr": 1, "update": ITERS}
    for i, got in enumerate(counts):
        want = dict(per_forward) if i < 2 else {
            **per_forward, "loss": 1, "backward": 1, "optimizer": 2}
        assert dict(got) == want, i
    forwards = [s for s in spans if s[0] == "forward"]
    for s in spans:
        if s[0] in FORWARD[1:]:
            assert any(_inside(s, f) for f in forwards), s
        if s[0] in ("loss", "backward", "optimizer"):
            assert not any(_inside(s, f) for f in forwards), s
    for st in steps[2:]:
        fwd, loss, bwd = (next(s for s in spans if s[0] == name
                               and _inside(s, st))
                          for name in ("forward", "loss", "backward"))
        assert fwd[2] <= loss[1] + EPS_US and loss[2] <= bwd[1] + EPS_US


def test_span_is_shared_null_without_profiler(monkeypatch):
    """No profiler: one shared null context, whatever the name, and no
    record_function made."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = timers.span("forward"), timers.span("step", 3)
    assert a is b is timers._NULL
    with a, b:
        pass


def test_timers_open_their_span(tmp_path, monkeypatch):
    """Timer and DeviceTimer blocks are spans of their own name; a span
    with args carries them after '#'."""
    monkeypatch.setattr(timers, "timers", type(timers.timers)(list))
    monkeypatch.setattr(timers, "cuda_timers", type(timers.timers)(list))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.Timer(timer_name="host_block"):
            with timers.DeviceTimer(timer_name="device_block"):
                torch.ones(4).sum()
        with timers.span("step", 7):
            pass
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["host_block", "device_block", "step#7"]
    assert _inside(spans[1], spans[0])


# -- the conv kernels' host side: bflow.conv_layout, bflow.conv_prep -----

KERNEL_PATH = dict(compute_dtype="bfloat16", corr_precision="bfloat16",
                   pallas_conv=True, pallas_stem=True)


def _twin_launch(x, w, b, stride, relu=False):
    """The conv kernels' launch with the device's work done by the plain
    twin: the host side as ``conv_common.launch_cuda`` runs it (the
    prepared weights, the input in the kernels' layout), then the plain
    conv over exactly those buffers."""
    prep = conv_common.prepared(w, b)
    xk = conv_common.kernel_input(x, prep.cp)
    return conv_common.conv_plain(xk, prep.w.permute(0, 3, 1, 2), prep.b,
                                  stride, relu)


@pytest.fixture
def kernel_path(monkeypatch):
    """The DSEC model in the bf16 fast mode with pallas_conv and
    pallas_stem, its CPU convs sent through the kernels' host side
    (_twin_launch); the counters reset. Returns (eval step, batch)."""
    monkeypatch.setattr(conv3x3, "conv_plain", _twin_launch)
    monkeypatch.setattr(stem_conv, "conv_plain", _twin_launch)
    model, task, batch = _setup("dsec", kernel_path=True)
    conv_common.reset_counters()
    return make_eval_step(model, task), batch


def _conv_spans(spans):
    return [s for s in spans if s[0] in ("conv_layout", "conv_prep")]


def test_conv_spans_open_inside_the_step_and_prep_only_once(kernel_path,
                                                            tmp_path):
    """Two profiled eval steps on the kernel path: every layout copy and
    every cache miss is one closed span inside its step; the first step
    prepares the weights, the second prepares nothing (no bflow.conv_prep,
    no miss) and copies the same layouts again."""
    step, batch = kernel_path
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
        first = (conv_common.layout_copies, conv_common.cache_misses)
        conv_common.reset_counters()
        step(batch)
        second = (conv_common.layout_copies, conv_common.cache_misses,
                  conv_common.cache_hits)
    spans = _spans(prof, tmp_path)
    steps, counts = _by_step(spans)
    assert [s[0] for s in steps] == ["step#0", "step#1"]
    copies, misses = first
    assert copies > 0 and misses > 0, first
    assert counts[0]["conv_layout"] == copies
    assert counts[0]["conv_prep"] == misses
    assert second[:2] == (copies, 0) and second[2] > 0, second
    assert counts[1]["conv_layout"] == copies
    assert "conv_prep" not in counts[1]
    for s in _conv_spans(spans):
        assert s[2] >= s[1], s
    # nothing else opened: the eval step's own spans and these two
    assert {s[0].split("#")[0] for s in spans} == {
        "step", *FORWARD, "conv_layout", "conv_prep"}


def test_conv_spans_stay_closed_without_profiler(kernel_path, monkeypatch):
    """No profiler: the kernel path copies and prepares (the counters
    move) but makes no record_function."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler")

    step, batch = kernel_path
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step(batch)
    assert conv_common.layout_copies > 0
    assert conv_common.cache_misses > 0 and conv_common.weight_preps > 0


def test_cache_counters_reset(kernel_path):
    """cached's hit and miss counters count every lookup and go back to 0
    with reset_counters(), with the layout and prep counters."""
    step, batch = kernel_path
    step(batch)
    step(batch)
    assert conv_common.cache_hits > 0 and conv_common.cache_misses > 0
    assert conv_common.weight_preps <= conv_common.cache_misses
    conv_common.reset_counters()
    assert (conv_common.cache_hits, conv_common.cache_misses,
            conv_common.layout_copies, conv_common.weight_preps) == (
                0, 0, 0, 0)
