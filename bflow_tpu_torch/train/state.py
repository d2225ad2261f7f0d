"""Training state: step count, model, optimizer and scheduler.

Counterpart of bflow_tpu/train/state.py. The model holds the parameters
and the BatchNorm running statistics (the JAX state's params and
batch_stats); ``create`` can start it from a JAX variables tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch

from bflow_tpu_torch.train.optimizer import build_optimizer
from bflow_tpu_torch.weights import load_jax_variables


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any

    @classmethod
    def create(cls, model: torch.nn.Module, training_cfg: Dict[str, Any],
               variables: Optional[Mapping[str, Any]] = None
               ) -> "TrainState":
        """State at step 0 for ``model``, optionally loading flax
        variables ({'params', 'batch_stats'}) first; the model is put in
        train mode."""
        if variables is not None:
            load_jax_variables(model, variables)
        model.train()
        opt, sched = build_optimizer(training_cfg, model.parameters())
        return cls(step=0, model=model, optimizer=opt, scheduler=sched)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
