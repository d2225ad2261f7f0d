"""Train and eval steps for both dataset families.

Counterpart of bflow_tpu/train/step.py. One train step: the forward in
train mode (every refinement iteration's prediction; BatchNorm on batch
statistics), the sequence loss and the metrics per dataset family,
backward, the element-wise gradient clamp and AdamW (the optimizer's
step), and one scheduler step. Metrics stay on the device as
(value, weight) pairs; ``init_metric_acc`` / ``metric_acc_means``
accumulate them there and read them back in one transfer, so a train loop
need not synchronize with the device every step.

Under a process group (bflow_tpu_torch.parallel) the step is the JAX
package's step over the global batch, of which each rank holds a slice:
the forward runs through a DistributedDataParallel wrapper of the model
(the gradients the clamp, grad_norm_tree and AdamW see are reduced), the
BatchNorm statistics are global (models/extractor.py), each loss divides
by the global valid count (utils/losses.py), and every metric's masked
sums are all-reduced in one vector before the means (utils/metrics.py);
the eval step reduces its metrics the same way.

Batches use the JAX package's keys and layouts: ``ev_repr`` (N, H, W,
bins), ``img`` (2, N, H, W, 3), ``flow`` (N, H, W, 2) for DSEC or
(M, N, H, W, 2) stacked over MultiFlow's M supervision times, and
``flow_valid`` (N, H, W).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from bflow_tpu_torch.data.keys import DataLoading as K
from bflow_tpu_torch.ops.bezier import BezierCurves
from bflow_tpu_torch.parallel.distributed import is_initialized
from bflow_tpu_torch.parallel.mesh import replicate
from bflow_tpu_torch.utils import metrics as M
from bflow_tpu_torch.utils.losses import (
    data_parallel_count,
    l1_multi_seq_loss_masked,
    l1_seq_loss_masked,
)
from bflow_tpu_torch.utils.host_memory import reuse_large_host_buffers
from bflow_tpu_torch.utils.padder import InputPadder
from bflow_tpu_torch.utils.precision import full_f32
from bflow_tpu_torch.utils.timers import span

EV_REPR, IMG, FLOW, FLOW_VALID = (K.EV_REPR.value, K.IMG.value,
                                  K.FLOW.value, K.FLOW_VALID.value)


@dataclass(frozen=True)
class TaskConfig:
    """Static supervision recipe."""

    dataset: str  # 'dsec' | 'multiflow2d'
    multi_loss: bool = False
    # MultiFlow ground-truth supervision timestamps, normalized to [0, 1]
    supervision_timestamps: Tuple[float, ...] = ()
    gamma: float = 0.8

    def __post_init__(self):
        if self.dataset not in ("dsec", "multiflow2d"):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.dataset == "multiflow2d" and not self.supervision_timestamps:
            raise ValueError("multiflow2d needs supervision_timestamps")


def _unpack(batch: Dict[str, Any], use_images: bool):
    voxel = batch.get(EV_REPR)
    images = batch.get(IMG) if use_images else None
    return voxel, images, batch[FLOW], batch.get(FLOW_VALID)


def grad_norm_tree(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Mean |grad| per parameter, keyed by its name (the payload of the
    reference's gradient-magnitude figure); on the device."""
    return {name: p.grad.detach().abs().mean().float()
            for name, p in model.named_parameters() if p.grad is not None}


def _family_metrics(task: TaskConfig, prefix: str, preds_at, flow, valid
                    ) -> Dict[str, M.Metric]:
    """The metric dict of step.py for one family, from the final
    prediction: preds_at(t) is its flow at time t."""
    out: Dict[str, M.Metric] = {}
    if task.dataset == "dsec":
        for k, v in M.single_flow_metrics(preds_at(1.0), flow,
                                          valid).items():
            out[f"{prefix}/{k}"] = v
        return out
    ts = task.supervision_timestamps
    targets = [flow[i] for i in range(len(ts))]
    final = [preds_at(t) for t in ts]
    for k, v in M.single_flow_metrics(final[-1], targets[-1]).items():
        out[f"{prefix}/{k}"] = v
    out[f"{prefix}/epe_multi"] = M.epe_multi(final, targets)
    out[f"{prefix}/ae_multi"] = M.ae_multi(final, targets)
    lin = M.predictions_from_lin_assumption(final[-1], ts)
    out[f"{prefix}/epe_multi_lin"] = M.epe_multi(lin, targets)
    out[f"{prefix}/ae_multi_lin"] = M.ae_multi(lin, targets)
    return out


def make_loss_fn(model: torch.nn.Module, task: TaskConfig, forward=None):
    """loss_fn(batch) -> (loss, metrics): the train-mode forward over
    cfg.iters_train iterations and the family's sequence loss, as the JAX
    train step's loss_fn (the metrics are detached). ``forward`` runs the
    model (default: the model itself; the train step's DDP wrapper under
    a process group, where the loss and metrics are the global batch's,
    as the module docstring says). The loss and the metrics, after the
    forward, run in the span ``bflow.loss`` (utils/timers.py)."""
    cfg = model.config
    forward = model if forward is None else forward

    def loss_fn(batch):
        voxel, images, flow, valid = _unpack(batch, cfg.use_images)
        ranks = is_initialized()
        preds = forward(voxel, images, iters=cfg.iters_train,
                        test_mode=False)
        with span("loss"):
            if task.dataset == "dsec":
                count = data_parallel_count(flow, valid) if ranks else None
                flows = [p.flow_at(1.0) for p in preds]
                loss = l1_seq_loss_masked(flows, flow, valid, task.gamma,
                                          count)
                loss_key = "train/l1_seq_loss"
            else:
                ts = task.supervision_timestamps
                targets = [flow[i] for i in range(len(ts))]
                # MultiFlow is unmasked and every time has the same pixels
                count = data_parallel_count(targets[0]) if ranks else None
                flows_it = [[p.flow_at(t) for t in ts] for p in preds]
                if task.multi_loss:
                    loss = l1_multi_seq_loss_masked(
                        flows_it, targets, None, task.gamma,
                        None if count is None else [count] * len(ts))
                    loss_key = "train/l1_multi_seq_loss"
                else:
                    loss = l1_seq_loss_masked([row[-1] for row in flows_it],
                                              targets[-1], None, task.gamma,
                                              count)
                    loss_key = "train/l1_seq_loss"
            with torch.no_grad():
                last = BezierCurves(preds[-1].params.detach())
                metrics = {loss_key: M.scalar_metric(loss.detach())}
                metrics.update(_family_metrics(task, "train", last.flow_at,
                                               flow, valid))
                if ranks:
                    metrics = M.global_metrics(metrics)
        return loss, metrics

    return loss_fn


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """The DDP wrapper a train step runs its forward through under a
    process group. ``broadcast_buffers`` is off because every rank
    computes the same global BatchNorm statistics; DDP's start-up sync
    then leaves the buffers out (torch 2.11 has no switch that syncs them
    at start-up alone), so ``replicate`` is the one start-up sync, of
    rank 0's weights and statistics, and DDP's own is off."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    replicate(model)
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, init_sync=False)


def make_train_step(model: torch.nn.Module, task: TaskConfig,
                    optimizer: torch.optim.Optimizer, scheduler,
                    with_grad_norms: bool = False):
    """train_step(batch, metric_acc=None) runs one step in place on model,
    optimizer and scheduler. Returns the metrics dict, or with
    ``metric_acc`` (from init_metric_acc) the accumulator with this
    step's (value * weight, weight) added, on the device; with
    ``with_grad_norms`` also grad_norm_tree of the unclamped gradients.
    Under a process group the forward runs through ``data_parallel``.
    Forward and backward run in full f32 (utils/precision.py). A step is
    the span ``bflow.step#<call>`` (its calls counted from 0), around
    ``bflow.forward``, ``bflow.loss``, ``bflow.backward`` and two
    ``bflow.optimizer`` (the gradients' reset; clamp, AdamW and the
    schedule) (utils/timers.py)."""
    loss_fn = make_loss_fn(
        model, task, data_parallel(model) if is_initialized() else None)
    calls = itertools.count()

    def train_step(batch, metric_acc=None):
        with span("step", next(calls)):
            return _train(batch, metric_acc)

    def _train(batch, metric_acc):
        model.train()
        with span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with full_f32():  # the backward too: it runs outside the forward
            loss, metrics = loss_fn(batch)
            with span("backward"):
                loss.backward()
        norms = grad_norm_tree(model) if with_grad_norms else None
        with span("optimizer"):
            optimizer.step()  # clamps the gradients first (ClampedAdamW)
            scheduler.step()
        out = metrics
        if metric_acc is not None:
            out = {k: (metric_acc[k][0] + v * w, metric_acc[k][1] + w)
                   for k, (v, w) in metrics.items()}
        return (out, norms) if with_grad_norms else out

    return train_step


def train_metric_keys(task: TaskConfig) -> Tuple[str, ...]:
    """The metric keys a train step emits, static per task."""
    singles = ("epe", "ae", "1pe", "2pe", "3pe")
    if task.dataset == "dsec":
        return ("train/l1_seq_loss",) + tuple(f"train/{k}" for k in singles)
    loss = ("train/l1_multi_seq_loss" if task.multi_loss
            else "train/l1_seq_loss")
    return ((loss,) + tuple(f"train/{k}" for k in singles)
            + ("train/epe_multi", "train/ae_multi", "train/epe_multi_lin",
               "train/ae_multi_lin"))


def init_metric_acc(keys: Iterable[str], device="cuda"
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed (weighted sum, weight) accumulator on the device."""
    return {k: (torch.zeros((), device=device),
                torch.zeros((), device=device)) for k in keys}


def metric_acc_means(metric_acc) -> Dict[str, float]:
    """One host readback -> mean per metric (metrics of zero weight are
    left out)."""
    keys = list(metric_acc)
    if not keys:
        return {}
    host = torch.stack([torch.stack([metric_acc[k][0].float(),
                                     metric_acc[k][1].float()])
                        for k in keys]).double().cpu()
    return {k: float(total / weight)
            for k, (total, weight) in zip(keys, host) if weight > 0}


def make_eval_step(model: torch.nn.Module, task: TaskConfig,
                   over_ranks: Optional[bool] = None):
    """eval_step(batch) -> (metrics, prediction (N, H, W, 2) at the last
    supervision time, low-res Bezier params). The test_mode forward on
    running BatchNorm statistics; inputs whose size is not a multiple of 8
    are padded for the forward and the prediction is cropped back. With
    ``over_ranks`` (default: under a process group) the metrics are the
    global batch's, a collective every rank must join; False keeps them
    this rank's (the media of rank 0 alone). Runs in full f32
    (utils/precision.py), in the span ``bflow.step#<call>`` (its calls
    counted from 0; utils/timers.py), which holds the forward's spans and,
    after them, the metrics and the prediction. A model on the GPU sets the
    process's malloc to reuse large host buffers, so that reading the
    prediction back maps no pages anew each batch
    (utils/host_memory.py)."""
    cfg = model.config
    if over_ranks is None:
        over_ranks = is_initialized()
    if next(model.parameters()).is_cuda:
        reuse_large_host_buffers()
    calls = itertools.count()

    def eval_step(batch):
        with span("step", next(calls)), full_f32():
            return _eval(batch)

    def _eval(batch):
        voxel, images, flow, valid = _unpack(batch, cfg.use_images)
        ref = voxel if voxel is not None else images[0]
        H, W = ref.shape[-3], ref.shape[-2]
        padder = InputPadder()
        padded = padder.requires_padding(H, W)
        if padded:
            voxel = None if voxel is None else padder.pad(voxel)
            images = None if images is None else padder.pad(images)
        was_training = model.training
        model.eval()
        try:
            low, up = model(voxel, images, iters=cfg.iters_test,
                            test_mode=True)
        finally:
            model.train(was_training)
        if padded:
            p = up.params
            flat = padder.unpad(p.reshape(*p.shape[:3], -1), H, W)
            up = BezierCurves(flat.reshape(*flat.shape[:3], *p.shape[3:]))
        metrics = _family_metrics(task, "val", up.flow_at, flow, valid)
        if over_ranks:
            with torch.no_grad():
                metrics = M.global_metrics(metrics)
        ts = (1.0,) if task.dataset == "dsec" else task.supervision_timestamps
        return metrics, up.flow_at(ts[-1]), low.params

    return eval_step
