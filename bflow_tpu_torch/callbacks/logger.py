"""Media logging callback: summary images + Bezier trajectory grids (the
port's counterpart of bflow_tpu/callbacks/logger.py).

Throttled train-batch summary strips (event representation, boundary
frame, prediction, ground truth, error heatmap), Bezier trajectory grids,
gradient-magnitude bar charts, and deterministic subsampling of
validation batches to bound memory; the same keys, steps and seed-0
validation plan as the JAX package's. Batches, predictions and gradient
norms may be tensors on the device: only the item rendered is copied to
the host. Disabled entirely by `logging.only_numbers`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from bflow_tpu_torch.callbacks.visualization import (
    ERROR_CLIP,
    bezier_trajectory_image,
    grad_flow_image,
    summary_image,
)
from bflow_tpu_torch.data.keys import DataLoading as K


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class MediaLogger:
    def __init__(
        self,
        logger,
        dataset: str,
        every_n_steps: int = 5000,
        n_val_predictions: int = 2,
        enabled: bool = True,
    ):
        self.logger = logger  # needs .log_image(key, image, step)
        self.dataset = dataset
        self.every_n_steps = max(1, every_n_steps)
        self.n_val = n_val_predictions
        self.enabled = enabled and hasattr(logger, "log_image")
        self._last_step = -(10**9)
        self._last_grad_step = -(10**9)
        self._val_indices: Optional[set] = None

    def plan_validation(self, n_batches: int) -> None:
        """Deterministically pick which validation batches to render
        (a seed-0 sample) so media RAM stays bounded and runs are
        comparable."""
        n = min(self.n_val, n_batches)
        random.seed(0)
        self._val_indices = set(random.sample(range(n_batches), n))

    def _render(self, batch: Dict[str, Any], pred_flow, i: int):
        ev = batch.get(K.EV_REPR.value)
        img = batch.get(K.IMG.value)
        flow = batch[K.FLOW.value]
        gt = _host(flow[-1, i] if flow.ndim == 5 else flow[i])
        valid = batch.get(K.FLOW_VALID.value)
        return summary_image(
            pred_flow=_host(pred_flow[i]),
            gt_flow=gt,
            valid=_host(valid[i]) if valid is not None else None,
            ev_repr_sum=_host(ev[i]).sum(-1) if ev is not None else None,
            image=_host(img[0, i]) if img is not None else None,
            error_clip=ERROR_CLIP.get(self.dataset, 3.0),
        )

    def on_train_batch(
        self,
        step: int,
        batch: Dict[str, Any],
        pred_flow,
        bezier_params=None,
    ) -> None:
        if not self.enabled or step - self._last_step < self.every_n_steps:
            return
        self._last_step = step
        strip = self._render(batch, pred_flow, 0)
        self.logger.log_image("train/summary", strip, step)
        if bezier_params is not None and bezier_params.shape[-2] > 1:
            self.logger.log_image(
                "train/bezier_trajectories",
                bezier_trajectory_image(_host(bezier_params[0])), step,
            )

    def on_validation_batch(
        self,
        step: int,
        batch_idx: int,
        batch: Dict[str, Any],
        pred_flow,
        bezier_params=None,
    ) -> None:
        if not self.enabled:
            return
        if self._val_indices is not None:
            if batch_idx not in self._val_indices:
                return
        elif batch_idx >= self.n_val:  # fallback: first-n
            return
        strip = self._render(batch, pred_flow, 0)
        self.logger.log_image(f"val/summary_{batch_idx}", strip, step)
        if bezier_params is not None and bezier_params.shape[-2] > 1:
            self.logger.log_image(
                f"val/bezier_trajectories_{batch_idx}",
                bezier_trajectory_image(_host(bezier_params[0])), step,
            )

    def on_after_backward(self, step: int, named_grad_norms) -> None:
        """Gradient-magnitude bar chart at logging cadence.
        `named_grad_norms` maps a parameter name to its mean |grad| (see
        train.step.grad_norm_tree), read back in one transfer."""
        if not self.enabled or step - self._last_grad_step < self.every_n_steps:
            return
        self._last_grad_step = step
        names = list(named_grad_norms)
        vals = [named_grad_norms[k] for k in names]
        if vals and isinstance(vals[0], torch.Tensor):
            vals = torch.stack([v.float() for v in vals]).cpu().tolist()
        items = sorted((k, float(v)) for k, v in zip(names, vals))
        self.logger.log_image("train/gradients", grad_flow_image(items), step)
