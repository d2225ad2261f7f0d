"""Weights & Biases logger with artifact-based checkpoint mirroring (the
port's counterpart of bflow_tpu/loggers/wandb_logger.py).

Stable run ids with resume="allow", global-step x-axis, checkpoint upload
as versioned artifacts with score metadata and best/last aliases, remote
top-k garbage collection, and artifact download for resume. Gated on
wandb being importable and not switched off by wandb's own
``WANDB_MODE=disabled``: otherwise the class is a no-op and says so once,
and the run logs to CSV only. Under ``WANDB_MODE=offline`` it logs
locally and never calls the W&B API (artifact clean-up and download).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

try:
    import wandb  # type: ignore
except ImportError:
    wandb = None


class WandbLogger:
    def __init__(
        self,
        project: str,
        group: Optional[str] = None,
        run_id: Optional[str] = None,
        log_model: bool = True,
        config: Optional[Dict[str, Any]] = None,
        top_k: int = 1,
    ):
        mode = os.environ.get("WANDB_MODE", "").lower()
        self.enabled = wandb is not None and mode != "disabled"
        self.online = self.enabled and mode != "offline"
        self.log_model = log_model
        self.top_k = top_k
        self._run = None
        if not self.enabled:
            print("wandb not available — W&B logging disabled"
                  if wandb is None else
                  "WANDB_MODE=disabled — W&B logging disabled")
            return
        self._run = wandb.init(
            project=project,
            group=group,
            id=run_id,
            resume="allow",
            config=config,
        )
        # make the trainer step the universal x-axis
        self._run.define_metric("trainer/global_step")
        self._run.define_metric(
            "*", step_metric="trainer/global_step", step_sync=True
        )

    @property
    def run_id(self) -> Optional[str]:
        return self._run.id if self._run else None

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        self._run.log(
            {**metrics, "trainer/global_step": step}, commit=True
        )

    def log_image(self, key: str, image, step: int, caption: str = "") -> None:
        if not self.enabled:
            return
        self._run.log(
            {key: wandb.Image(image, caption=caption),
             "trainer/global_step": step},
        )

    def log_histograms(
        self, model: torch.nn.Module, step: int, prefix: str = "parameters"
    ) -> None:
        """Histogram every parameter, keyed by its name in
        ``named_parameters()`` (the reference's `logger.watch(net,
        log='all')`)."""
        if not self.enabled:
            return
        payload = {
            f"{prefix}/{name}": wandb.Histogram(
                p.detach().float().cpu().numpy().ravel())
            for name, p in model.named_parameters()
        }
        self._run.log({**payload, "trainer/global_step": step})

    # -- checkpoint artifacts -------------------------------------------------

    def upload_checkpoint(
        self,
        ckpt_path: str,
        step: int,
        score: Optional[float] = None,
        aliases: Optional[list] = None,
    ) -> None:
        """Upload a checkpoint file (or directory) as a model artifact."""
        if not (self.enabled and self.log_model):
            return
        art = wandb.Artifact(
            name=f"checkpoint-{self._run.id}",
            type="model",
            metadata={"step": step, "score": score},
        )
        if Path(ckpt_path).is_dir():
            art.add_dir(str(ckpt_path))
        else:
            art.add_file(str(ckpt_path))
        self._run.log_artifact(art, aliases=aliases or ["last"])
        self._gc_artifacts()

    def _gc_artifacts(self) -> None:
        """Delete remote checkpoint versions beyond top-k (+aliases)."""
        if not self.online:
            return
        try:
            api = wandb.Api()
            versions = api.artifact_versions(
                "model", f"{self._run.entity}/{self._run.project}/"
                f"checkpoint-{self._run.id}"
            )
            scored = [v for v in versions if not v.aliases]
            for v in scored[self.top_k:]:
                v.delete()
        except Exception:
            pass  # GC is best-effort

    def download_checkpoint(
        self, artifact_runpath: str, artifact_name: str
    ) -> Optional[Path]:
        if not self.online:
            return None
        api = wandb.Api()
        art = api.artifact(f"{artifact_runpath}/{artifact_name}")
        return Path(art.download())

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()
