"""Training of the port: optimizer, schedule, state, steps and
checkpoints (counterparts of bflow_tpu/train)."""

from bflow_tpu_torch.train.checkpoint import CheckpointManager
from bflow_tpu_torch.train.optimizer import build_optimizer
from bflow_tpu_torch.train.schedule import onecycle_linear_schedule
from bflow_tpu_torch.train.state import TrainState
from bflow_tpu_torch.train.step import (
    TaskConfig,
    make_eval_step,
    make_train_step,
)

__all__ = ["CheckpointManager", "TaskConfig", "TrainState",
           "build_optimizer", "make_eval_step", "make_train_step",
           "onecycle_linear_schedule"]
