"""Learning-rate schedule: the linear one-cycle of the reference.

Counterpart of bflow_tpu/train/schedule.py, which copies torch's
OneCycleLR (anneal_strategy='linear', three_phase=False) step for step;
here it is torch's own. ``cycle_momentum`` must stay False: the JAX chain
keeps Adam's b1 at 0.9 for the whole run (bflow_tpu/train/optimizer.py),
and OneCycleLR would otherwise cycle b1 between 0.85 and 0.95.
"""

from __future__ import annotations

import torch


def onecycle_linear_schedule(optimizer: torch.optim.Optimizer,
                             max_lr: float, total_steps: int,
                             pct_start: float = 0.01,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4,
                             ) -> torch.optim.lr_scheduler.OneCycleLR:
    """Two-phase linear one-cycle over ``total_steps`` scheduler steps:
    max_lr/div -> max_lr over the first pct_start, then down to
    max_lr/div/final_div. Sets the optimizer's lr to the step-0 value."""
    return torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=max_lr, total_steps=total_steps,
        pct_start=pct_start, anneal_strategy="linear", three_phase=False,
        cycle_momentum=False, div_factor=div_factor,
        final_div_factor=final_div_factor)
