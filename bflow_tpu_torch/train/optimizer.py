"""Optimizer assembly: element-wise gradient clamp + AdamW + OneCycle.

Counterpart of bflow_tpu/train/optimizer.py (optax.chain(clip, adamw)):
each gradient element is clamped to +-clip (the reference's torch hooks
clamp; this is not norm clipping), then AdamW with torch's defaults
(b1 0.9, b2 0.999, eps 1e-8) and decoupled weight decay, on the linear
one-cycle schedule over total_steps + 100 (the reference's slack).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from bflow_tpu_torch.train.schedule import onecycle_linear_schedule


class ClampedAdamW(torch.optim.AdamW):
    """AdamW whose step first clamps every gradient element to
    [-grad_clip, grad_clip] in place (optax.clip ahead of optax.adamw)."""

    def __init__(self, params, grad_clip: Optional[float] = None, **kw):
        super().__init__(params, **kw)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip is not None:
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.clamp_(-self.grad_clip, self.grad_clip)
        return super().step(closure)


def build_optimizer(
    training_cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter],
) -> Tuple[ClampedAdamW, torch.optim.lr_scheduler.LRScheduler]:
    """From the ``training:`` config group. Returns (optimizer,
    scheduler); step the scheduler once after every optimizer step. With
    the scheduler off, the scheduler keeps the lr constant."""
    lr = float(training_cfg["learning_rate"])
    wd = float(training_cfg["weight_decay"])
    clip = training_cfg.get("gradient_clip_val")
    clip = float(clip) if clip is not None and float(clip) > 0 else None
    opt = ClampedAdamW(params, grad_clip=clip, lr=lr, betas=(0.9, 0.999),
                       eps=1e-8, weight_decay=wd)
    sched_cfg = training_cfg.get("lr_scheduler") or {}
    if sched_cfg.get("use", False):
        sched = onecycle_linear_schedule(
            opt, max_lr=lr,
            total_steps=int(sched_cfg["total_steps"]) + 100,
            pct_start=float(sched_cfg.get("pct_start", 0.01)))
    else:
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    return opt, sched
