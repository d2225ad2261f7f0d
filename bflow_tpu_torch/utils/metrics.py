"""Optical-flow metrics: tensor functions and a host-side accumulator bank.

Counterpart of bflow_tpu/utils/metrics.py. Each function returns a
``Metric``, which unpacks as ``(value, valid)``, 0-d tensors on the
inputs' device: ``valid`` is 0 when the reference would have skipped the
update (no valid pixels), so a train loop can accumulate them on the
device and read back only at its logging cadence. Streaming across steps
happens on the host in float64 (``MetricBank``), as the reference's
torchmetrics states do.

A ``Metric`` keeps the masked sums it is computed from, so that a
data-parallel step can make every mean one over the global batch, as the
JAX package's are on a sharded array: ``global_metrics`` all-reduces the
sums of all of a step's metrics in one packed vector, with no host
synchronisation, and then finishes each metric from them.

Layout: flows (N, H, W, 2) channels-last, masks (N, H, W) bool.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bflow_tpu_torch.parallel.distributed import all_reduce_sum
from bflow_tpu_torch.utils.losses import l1_loss_masked

MetricUpdate = Tuple[torch.Tensor, torch.Tensor]  # (value, valid in {0,1})


def _first(means: torch.Tensor, valid: torch.Tensor) -> MetricUpdate:
    return means[0], valid[0]


@dataclass(frozen=True)
class Metric:
    """One metric of a batch as its masked sums: ``sums`` (k, 2) holds k
    rows [sum(value * mask), sum(mask)] (an unmasked mean's mask is all
    ones), and ``finish`` takes the rows' means num / max(den, 1) and
    valid flags den > 0 to the metric's (value, valid). Unpacks as that
    pair."""

    sums: torch.Tensor
    finish: Callable[[torch.Tensor, torch.Tensor], MetricUpdate] = _first

    def update(self) -> MetricUpdate:
        num, den = self.sums.unbind(-1)
        return self.finish(num / den.clamp(min=1.0),
                           (den > 0).to(torch.float32))

    def __iter__(self):
        return iter(self.update())

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.update()[i]


def scalar_metric(value: torch.Tensor) -> Metric:
    """A per-rank scalar (the loss) as a Metric of weight 1: over a
    process group its global value is the mean over ranks."""
    return Metric(torch.stack([value.float(), value.new_ones(())])[None])


def _masked_mean(values: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> Metric:
    if mask is None:
        num, den = values.sum(), values.new_full((), float(values.numel()))
    else:
        m = mask.to(values.dtype)
        num, den = (values * m).sum(), m.sum()
    return Metric(torch.stack([num, den])[None])


def global_metrics(metrics: Dict[str, Metric]) -> Dict[str, Metric]:
    """The metrics with every sum replaced by its sum over the ranks of
    the process group, taken in one all-reduce of one packed f32
    vector."""
    keys = list(metrics)
    if not keys:
        return {}
    sizes = [metrics[k].sums.shape[0] for k in keys]
    packed = all_reduce_sum(
        torch.cat([metrics[k].sums.float() for k in keys]))
    return {k: Metric(s, metrics[k].finish)
            for k, s in zip(keys, packed.split(sizes))}


def epe(source: torch.Tensor, target: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None) -> Metric:
    """End-point error: masked mean of the flow-error L2 norm."""
    assert source.shape == target.shape
    err = (source - target).square().sum(dim=-1).sqrt()
    return _masked_mean(err, valid_mask)


def angular_error(source: torch.Tensor, target: torch.Tensor,
                  valid_mask: Optional[torch.Tensor] = None,
                  degrees: bool = True) -> Metric:
    """Middlebury angular error with the homogeneous (append-1)
    extension."""
    assert source.shape == target.shape
    ones = source.new_ones(source.shape[:-1] + (1,))
    s = torch.cat([source, ones], dim=-1)
    t = torch.cat([target, ones], dim=-1)
    num = (s * t).sum(dim=-1)
    den = torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(
        t, dim=-1)
    ae = torch.arccos((num / den).clamp(-1.0, 1.0))
    if degrees:
        ae = ae / math.pi * 180.0
    return _masked_mean(ae, valid_mask)


def n_pixel_error(source: torch.Tensor, target: torch.Tensor,
                  valid_mask: Optional[torch.Tensor],
                  n_pixels: float) -> Metric:
    """Outlier percentage: error > n px AND relative error >= 5%."""
    assert source.shape == target.shape
    gt_magn = torch.linalg.vector_norm(target, dim=-1)
    err_magn = torch.linalg.vector_norm(source - target, dim=-1)
    rel = err_magn / gt_magn.clamp(min=1e-6)
    outlier = ((err_magn > n_pixels) & (rel >= 0.05)).to(torch.float32)
    return Metric(_masked_mean(outlier, valid_mask).sums, _percent)


def _percent(means: torch.Tensor, valid: torch.Tensor) -> MetricUpdate:
    return means[0] * 100.0, valid[0]


def _over_times(means: torch.Tensor, valid: torch.Tensor) -> MetricUpdate:
    """Mean of the per-time values whose update is valid (an all-invalid
    timestamp does not enter the mean)."""
    count = valid.sum()
    return ((means * valid).sum() / count.clamp(min=1.0),
            (count > 0).to(torch.float32))


def _weighted_over_times(per_time: Sequence[Metric]) -> Metric:
    return Metric(torch.cat([m.sums for m in per_time]), _over_times)


def epe_multi(sources: Sequence[torch.Tensor],
              targets: Sequence[torch.Tensor],
              valid_masks: Optional[Sequence[torch.Tensor]] = None,
              min_traj_len: Optional[float] = None,
              max_traj_len: Optional[float] = None) -> Metric:
    """Mean EPE over supervision timestamps, optionally gated by the
    ground-truth trajectory length (sum of consecutive displacements)."""
    n = len(sources)
    assert n > 0 and len(targets) == n
    masks: List[Optional[torch.Tensor]] = (
        list(valid_masks) if valid_masks is not None else [None] * n)
    if min_traj_len is not None or max_traj_len is not None:
        stack = torch.stack(list(targets), dim=0)
        traj = (stack[1:] - stack[:-1]).square().sum(-1).sqrt().sum(0)
        gate = torch.ones(traj.shape, dtype=torch.bool, device=traj.device)
        if min_traj_len is not None:
            gate &= traj >= min_traj_len
        if max_traj_len is not None:
            gate &= traj <= max_traj_len
        masks = [gate if m is None else (m & gate) for m in masks]
    return _weighted_over_times(
        [epe(s, t, m) for s, t, m in zip(sources, targets, masks)])


def ae_multi(sources: Sequence[torch.Tensor],
             targets: Sequence[torch.Tensor],
             valid_masks: Optional[Sequence[torch.Tensor]] = None,
             degrees: bool = True) -> Metric:
    """Mean angular error over supervision timestamps, weighted by each
    timestamp's validity exactly as epe_multi."""
    n = len(sources)
    assert n > 0 and len(targets) == n
    masks = list(valid_masks) if valid_masks is not None else [None] * n
    return _weighted_over_times(
        [angular_error(s, t, m, degrees=degrees)
         for s, t, m in zip(sources, targets, masks)])


def l1_channel_masked_metric(source: torch.Tensor, target: torch.Tensor,
                             valid_mask: Optional[torch.Tensor] = None
                             ) -> Metric:
    """The masked L1 loss (utils/losses.py:l1_loss_masked) as a metric
    whose valid flag is always 1, as the JAX package's is."""
    return scalar_metric(l1_loss_masked(source, target, valid_mask))


def predictions_from_lin_assumption(
    source: torch.Tensor, target_timestamps: Sequence[float],
) -> List[torch.Tensor]:
    """Linear-motion baseline: scale the final flow by each timestamp."""
    assert max(target_timestamps) <= 1 and min(target_timestamps) >= 0
    return [float(t) * source for t in target_timestamps]


def single_flow_metrics(source: torch.Tensor, target: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> Dict[str, Metric]:
    """The reference's single-flow MetricCollection: epe/ae/1pe/2pe/3pe."""
    return {
        "epe": epe(source, target, valid_mask),
        "ae": angular_error(source, target, valid_mask, degrees=True),
        "1pe": n_pixel_error(source, target, valid_mask, 1.0),
        "2pe": n_pixel_error(source, target, valid_mask, 2.0),
        "3pe": n_pixel_error(source, target, valid_mask, 3.0),
    }


class MetricBank:
    """Host-side float64 streaming accumulator (mean of per-step values),
    the reference's torchmetrics (sum, total) pairs: ``update`` adds one
    step's value per metric (skipping invalid updates), ``compute``
    returns the running means, ``reset`` clears them."""

    def __init__(self) -> None:
        self._sum: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}

    def update(self, updates: Dict[str, MetricUpdate]) -> None:
        for name, (value, valid) in updates.items():
            if float(valid) <= 0.0:
                continue
            self._sum[name] = self._sum.get(name, 0.0) + float(value)
            self._cnt[name] = self._cnt.get(name, 0) + 1

    def compute(self) -> Dict[str, float]:
        return {name: self._sum[name] / self._cnt[name]
                for name in self._sum if self._cnt.get(name, 0) > 0}

    def reset(self) -> None:
        self._sum.clear()
        self._cnt.clear()
