"""Port parity of the observability layer: bflow_tpu_torch.callbacks
(flow_vis, visualization, logger), loggers.wandb_logger,
train.checkpoint.resolve_artifact_checkpoint and utils.timers, against
their bflow_tpu counterparts.

Bit-equal: the color wheel and `flow_to_color`, the error heatmap (the
port's coolwarm table against matplotlib's colormap) and `summary_image`.
The MediaLogger logs the same keys at the same steps as the JAX one, with
the same seed-0 validation plan and the same summary strips, from numpy
arrays or tensors alike; its Bezier trajectory grid and gradient chart
(matplotlib figures in the JAX package, cv2 drawings here) are RGB uint8
arrays with content. `resolve_artifact_checkpoint` follows the cases of
tests/test_observability.py, the W&B logger is a no-op without wandb or
under WANDB_MODE=disabled, and the timer registry records and reports.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import pytest
import torch

from bflow_tpu.callbacks import flow_vis as jflow_vis
from bflow_tpu.callbacks import visualization as jvis
from bflow_tpu.callbacks.logger import MediaLogger as JaxMediaLogger
from bflow_tpu.train.checkpoint import (
    resolve_artifact_checkpoint as jax_resolve,
)
from bflow_tpu_torch.callbacks import flow_vis, visualization as vis
from bflow_tpu_torch.callbacks.logger import MediaLogger
from bflow_tpu_torch.data.keys import DataLoading as K
from bflow_tpu_torch.loggers import wandb_logger
from bflow_tpu_torch.train.checkpoint import resolve_artifact_checkpoint
from bflow_tpu_torch.utils import timers
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)


def _flow(rng, h=24, w=40, scale=5.0):
    return (scale * rng.standard_normal((h, w, 2))).astype(np.float32)


# ---------------------------------------------------------------- images


def test_colorwheel_bit_equal():
    np.testing.assert_array_equal(flow_vis.make_colorwheel(),
                                  jflow_vis.make_colorwheel())


@pytest.mark.parametrize("kw", [{}, {"clip_flow": 2.0}, {"rad_max": 3.0},
                                {"clip_flow": 1.0, "rad_max": 0.5}])
def test_flow_to_color_bit_equal(kw):
    rng = np.random.default_rng(1)
    flow = _flow(rng)
    flow[0, 0] = 0.0
    got = flow_vis.flow_to_color(flow, **kw)
    assert got.dtype == np.uint8 and got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, jflow_vis.flow_to_color(flow, **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coolwarm_table_is_matplotlibs(dtype):
    from matplotlib import cm

    v = np.concatenate([np.linspace(0, 1, 4097), [0.0, 1.0, 255 / 256,
                                                  1 / 256, np.nan]])
    v = v.astype(dtype)
    want = (cm.coolwarm(v)[..., :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(vis.coolwarm_u8(v), want)


@pytest.mark.parametrize("masked", [False, True])
def test_error_map_bit_equal(masked):
    rng = np.random.default_rng(2)
    pred, gt = _flow(rng), _flow(rng)
    valid = rng.random(pred.shape[:2]) > 0.3 if masked else None
    np.testing.assert_array_equal(
        vis.render_error_map(pred, gt, valid, clip=2.0),
        jvis.render_error_map(pred, gt, valid, clip=2.0))


PANELS = {
    "all": dict(gt=True, valid=True, ev=True, image=True),
    "no_gt": dict(gt=False, valid=False, ev=True, image=True),
    "events_only": dict(gt=True, valid=False, ev=True, image=False),
    "frames_only": dict(gt=True, valid=True, ev=False, image=True),
}


@pytest.mark.parametrize("panels", sorted(PANELS))
def test_summary_image_bit_equal(panels):
    p = PANELS[panels]
    rng = np.random.default_rng(3)
    kw = dict(
        pred_flow=_flow(rng),
        gt_flow=_flow(rng) if p["gt"] else None,
        valid=(rng.random((24, 40)) > 0.2) if p["valid"] else None,
        ev_repr_sum=(rng.standard_normal((24, 40)).astype(np.float32)
                     if p["ev"] else None),
        image=(rng.integers(0, 255, (24, 40, 3)).astype(np.float32)
               if p["image"] else None),
        error_clip=2.0)
    got = vis.summary_image(**kw)
    np.testing.assert_array_equal(got, jvis.summary_image(**kw))
    n = sum([p["ev"], p["image"], 1, 2 * p["gt"]])
    assert got.shape == (24, 40 * n, 3) and got.dtype == np.uint8


def _assert_drawn(img, shape=None):
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    if shape is not None:
        assert img.shape == shape
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 2  # not blank


@pytest.mark.parametrize("degree", [2, 10])
def test_bezier_trajectory_image(degree):
    rng = np.random.default_rng(4)
    params = rng.standard_normal((9, 12, degree, 2)).astype(np.float32)
    img = vis.bezier_trajectory_image(params)
    _assert_drawn(img, (600, 600, 3))
    # a straight curve and a still one draw too
    _assert_drawn(vis.bezier_trajectory_image(np.zeros_like(params), 3))


def test_grad_flow_image():
    items = [(f"p{i}", v) for i, v in enumerate(np.linspace(0, 2, 150))]
    img = vis.grad_flow_image(items)
    _assert_drawn(img, (240, 2 * 8 + 4 * 150, 3))
    _assert_drawn(vis.grad_flow_image([("a", 0.0)]))


# ---------------------------------------------------------------- media logger


class FakeLogger:
    enabled = True

    def __init__(self, download_result=None):
        self.images = []
        self.downloads = []
        self._download_result = download_result

    def log_image(self, key, image, step, caption=""):
        self.images.append((key, step, np.asarray(image)))

    def download_checkpoint(self, runpath, name):
        self.downloads.append((runpath, name))
        return self._download_result


def _batch(dataset, n=2, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    flow = rng.standard_normal((n, h, w, 2))
    if dataset == "multiflow2d":
        flow = rng.standard_normal((5, n, h, w, 2))
    batch = {
        K.EV_REPR.value: rng.standard_normal((n, h, w, 9)).astype(np.float32),
        K.IMG.value: rng.integers(0, 255, (2, n, h, w, 3)).astype(np.float32),
        K.FLOW.value: flow.astype(np.float32),
    }
    if dataset == "dsec":
        batch[K.FLOW_VALID.value] = rng.random((n, h, w)) > 0.2
    return batch


def _drive(logger_cls, dataset, tensors=False):
    """The loop's calls over 12 steps at a cadence of 5, then a validation
    of 7 batches, each logger under the same plan."""
    fake = FakeLogger()
    media = logger_cls(fake, dataset, every_n_steps=5, n_val_predictions=3)
    rng = np.random.default_rng(5)

    def conv(x):
        return torch.from_numpy(np.asarray(x)) if tensors else x

    bez = rng.standard_normal((2, 2, 3, 4, 2)).astype(np.float32)
    norms = {f"layer{i}.weight": np.float32(rng.random()) for i in range(6)}
    for step in range(1, 13):
        batch = _batch(dataset, seed=step)
        pred = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
        if step == 1 or step % 5 == 0 or step == 7:
            media.on_train_batch(step, {k: conv(v) for k, v in batch.items()},
                                 conv(pred), bezier_params=conv(bez))
            media.on_after_backward(
                step, {k: conv(v) for k, v in norms.items()})
    media.plan_validation(7)
    for v in range(7):
        batch = _batch(dataset, seed=100 + v)
        pred = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
        media.on_validation_batch(12, v, {k: conv(x) for k, x in
                                          batch.items()},
                                  conv(pred), bezier_params=conv(bez))
    return fake.images


@functools.lru_cache(maxsize=None)
def _jax_media(dataset):
    return _drive(JaxMediaLogger, dataset)  # matplotlib: ~1 s a figure


@pytest.mark.parametrize("dataset", ["dsec", "multiflow2d"])
@pytest.mark.parametrize("tensors", [False, True])
def test_media_logger_matches_jax(dataset, tensors):
    got = _drive(MediaLogger, dataset, tensors)
    want = _jax_media(dataset)
    assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
    random.seed(0)
    plan = set(random.sample(range(7), 3))
    logged = {int(k.rsplit("_", 1)[1]) for k, _, _ in got
              if k.startswith("val/summary_")}
    assert logged == plan
    assert {k for k, _, _ in got} >= {"train/summary", "train/gradients",
                                      "train/bezier_trajectories"}
    for (key, _, g), (_, _, w) in zip(got, want):
        if "summary" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            _assert_drawn(g)


def test_media_logger_disabled_logs_nothing():
    fake = FakeLogger()
    media = MediaLogger(fake, "dsec", every_n_steps=1, enabled=False)
    media.on_train_batch(1, _batch("dsec"), np.zeros((2, 16, 24, 2)))
    media.on_after_backward(1, {"a": 1.0})
    media.on_validation_batch(1, 0, _batch("dsec"), np.zeros((2, 16, 24, 2)))
    assert fake.images == []
    assert not MediaLogger(object(), "dsec").enabled  # no log_image


# ---------------------------------------------------------------- artifacts


def _resolve_both(cfg, make_logger):
    loggers = make_logger(), make_logger()
    got = resolve_artifact_checkpoint(cfg, loggers[0])
    want = jax_resolve(cfg, loggers[1])
    assert loggers[0].downloads == loggers[1].downloads
    return got, want, loggers[0]


def test_resolve_artifact_local_path(tmp_path):
    ckpt = tmp_path / "weights.ckpt"
    ckpt.write_bytes(b"x")
    got, want, logger = _resolve_both({"artifact_name": str(ckpt)},
                                      FakeLogger)
    assert got == want == ckpt and logger.downloads == []


@pytest.mark.parametrize("cfg", [{}, {"artifact_name": None}])
def test_resolve_artifact_none(cfg):
    got, want, _ = _resolve_both(cfg, FakeLogger)
    assert got is None and want is None


def test_resolve_artifact_requires_runpath(capsys):
    got, want, logger = _resolve_both(
        {"artifact_name": "checkpoint-abc:v3"}, FakeLogger)
    assert got is None and want is None and logger.downloads == []
    assert "artifact_runpath" in capsys.readouterr().out


@pytest.mark.parametrize("files,pick", [
    (["model.ckpt"], "model.ckpt"),
    (["last.pt", "meta.json"], "last.pt"),  # a port checkpoint
    (["state/"], "state"),  # a directory
])
def test_resolve_artifact_downloads(tmp_path, files, pick):
    art = tmp_path / "artifact"
    art.mkdir()
    for f in files:
        if f.endswith("/"):
            (art / f).mkdir()
        else:
            (art / f).write_bytes(b"x")
    cfg = {"artifact_name": "checkpoint-abc:v3",
           "artifact_runpath": "team/proj/run-1"}
    got = resolve_artifact_checkpoint(cfg, FakeLogger(art))
    assert got == art / pick
    if pick != "last.pt":  # the JAX package knows no .pt checkpoint
        assert jax_resolve(cfg, FakeLogger(art)) == got


def test_resolve_artifact_falls_back_to_wandb_runpath(tmp_path):
    art = tmp_path / "artifact"
    (art / "state").mkdir(parents=True)
    got, want, logger = _resolve_both(
        {"artifact_name": "checkpoint-abc:v3",
         "wandb_runpath": "team/proj/run-2"}, lambda: FakeLogger(art))
    assert got == want == art / "state"
    assert logger.downloads == [("team/proj/run-2", "checkpoint-abc:v3")]


# ---------------------------------------------------------------- W&B


class _NoInit:
    """A stand-in wandb module: any use of it fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"wandb.{name} used")


@pytest.mark.parametrize("how", ["absent", "disabled"])
def test_wandb_logger_no_op(monkeypatch, capsys, tmp_path, how):
    if how == "absent":
        monkeypatch.setattr(wandb_logger, "wandb", None)
    else:
        monkeypatch.setattr(wandb_logger, "wandb", _NoInit())
        monkeypatch.setenv("WANDB_MODE", "disabled")
    wb = wandb_logger.WandbLogger(project="p", group="g", config={"a": 1})
    assert not wb.enabled and not wb.online and wb.run_id is None
    assert "W&B logging disabled" in capsys.readouterr().out
    model = torch.nn.Linear(2, 2)
    wb.log({"x": 1.0}, 1)
    wb.log_image("k", np.zeros((2, 2, 3), np.uint8), 1)
    wb.log_histograms(model, 1)
    (tmp_path / "last.pt").write_bytes(b"x")
    wb.upload_checkpoint(str(tmp_path / "last.pt"), 1, score=0.5)
    assert wb.download_checkpoint("team/proj/run", "art:v0") is None
    wb.finalize()
    assert capsys.readouterr().out == ""  # said once


# ---------------------------------------------------------------- timers


def test_timers_registry(capsys, monkeypatch):
    monkeypatch.setattr(timers, "timers", type(timers.timers)(list))
    monkeypatch.setattr(timers, "cuda_timers", type(timers.timers)(list))
    for _ in range(3):
        with timers.Timer(timer_name="host_block"):
            pass
        with timers.DeviceTimer(timer_name="device_block"):
            torch.ones(4).sum()
    with timers.TimerDummy(timer_name="noop"):
        pass
    assert len(timers.timers["host_block"]) == 3
    assert len(timers.cuda_timers["device_block"]) == 3
    assert "noop" not in timers.timers and "noop" not in timers.cuda_timers
    assert all(v >= 0 for v in timers.cuda_timers["device_block"])
    timers.print_timing_info(warmup_iters=1)
    out = capsys.readouterr().out
    assert "host_block: mean" in out and "over 2 samples" in out
    assert "device_block: mean" in out
    with pytest.raises(AssertionError):
        timers.DeviceTimer()

    # on the card a DeviceTimer block records its CUDA event pair and does
    # not wait for the device: the summary reads the pairs
    syncs = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            pass

        def synchronize(self):
            syncs.append(self)

        def elapsed_time(self, end):
            return 2.0  # ms

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(None))
    monkeypatch.setattr(timers, "_pending", [])
    for _ in range(3):
        with timers.DeviceTimer(timer_name="card_block"):
            pass
    assert not syncs and not timers.cuda_timers["card_block"]
    timers.print_timing_info(warmup_iters=1)
    assert timers.cuda_timers["card_block"] == [2e-3] * 3
    assert "card_block: mean 2.00 ms over 2 samples" in capsys.readouterr().out
