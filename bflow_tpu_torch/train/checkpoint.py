"""Checkpoints of the training state, with the reference's policy.

Counterpart of bflow_tpu/train/checkpoint.py (orbax there, torch.save
here): "last" is written on every save, "best" whenever the monitored
metric improves (mode 'min' or 'max'), and ``meta.json`` keeps the best
score, the monitor and the last step, so a restarted run keeps its best.
``restore_weights_only`` reads either a port checkpoint or a reference
``.ckpt`` (a Lightning file whose ``net.*`` keys are the port's own
state_dict names); ``resolve_artifact_checkpoint`` finds the file that
`wandb.artifact_name` names.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from bflow_tpu_torch.train.state import TrainState

_FILES = {"last": "last.pt", "best": "best.pt"}


class CheckpointManager:
    def __init__(self, directory: str, monitor: str, mode: str):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self._best: Optional[float] = None
        self._meta_path = self.directory / "meta.json"
        if self._meta_path.exists():
            self._best = json.loads(self._meta_path.read_text()).get(
                "best_score")

    def path(self, which: str) -> Path:
        return self.directory / _FILES[which]

    def _save(self, which: str, state: TrainState) -> None:
        path = self.path(which)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # a reader never sees half a file

    def save(self, state: TrainState,
             metrics: Dict[str, float]) -> Dict[str, Any]:
        """Save 'last' always; refresh 'best' when the monitor improves."""
        self._save("last", state)
        score = metrics.get(self.monitor)
        improved = False
        if score is not None:
            score = float(score)
            if (self._best is None
                    or (self.mode == "min" and score < self._best)
                    or (self.mode == "max" and score > self._best)):
                self._best = score
                self._save("best", state)
                improved = True
        self._meta_path.write_text(json.dumps({
            "best_score": self._best, "monitor": self.monitor,
            "mode": self.mode, "last_step": int(state.step)}))
        return {"improved": improved, "best_score": self._best}

    def restore(self, state: TrainState, which: str = "last"
                ) -> Optional[TrainState]:
        """Load a saved state into ``state`` in place; None if there is
        no such checkpoint."""
        path = self.path(which)
        if not path.exists():
            return None
        state.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        return state


def resolve_artifact_checkpoint(wandb_cfg: Dict[str, Any], logger
                                ) -> Optional[Path]:
    """Resolve `wandb.artifact_name` to a local checkpoint path.

    A local path is used directly (a port checkpoint or a reference
    `.ckpt`); otherwise the logger downloads the artifact from
    `artifact_runpath`, falling back to `wandb_runpath`. In a downloaded
    directory a `.ckpt` file is preferred, then a port checkpoint (`.pt`),
    then the first subdirectory.
    """
    name = wandb_cfg.get("artifact_name")
    if not name:
        return None
    local = Path(name)
    if local.exists():
        return local
    runpath = wandb_cfg.get("artifact_runpath") or wandb_cfg.get("wandb_runpath")
    if runpath is None:
        print(
            "must specify wandb_runpath or artifact_runpath to restore a "
            "checkpoint/artifact. Cannot load artifact."
        )
        return None
    print(f"resuming checkpoint from runpath {runpath} and artifact {name}")
    downloaded = logger.download_checkpoint(runpath, name)
    if downloaded is None:
        return None
    downloaded = Path(downloaded)
    if downloaded.is_file():
        return downloaded
    for pattern in ("**/*.ckpt", "**/*.pt"):
        found = sorted(downloaded.glob(pattern))
        if found:
            return found[0]
    subdirs = [p for p in sorted(downloaded.iterdir()) if p.is_dir()]
    return subdirs[0] if subdirs else downloaded


def restore_weights_only(path: str, model: torch.nn.Module
                         ) -> torch.nn.Module:
    """Load only the weights (parameters and BatchNorm statistics) into
    ``model``, from a port checkpoint or a reference ``.ckpt``."""
    p = Path(path)
    ckpt = torch.load(p, map_location="cpu", weights_only=True)
    if p.suffix == ".ckpt":
        sd = {k[len("net."):]: v for k, v in ckpt["state_dict"].items()
              if k.startswith("net.")}
    else:
        sd = ckpt["model"]
    model.load_state_dict(sd)
    return model
