"""The reference's voxelizer, losses, metrics and optimizer, plain PyTorch.

- ``voxel_grid``: events to an (H, W, C) grid, bilinear in time for integer
  pixel coordinates, polarity as +-1, accumulated in f64.
- ``dsec_loss`` / ``multi_loss``: RAFT's sequence loss (gamma^(n-1-i)
  weights) of the per-pixel L1 error summed over x and y, masked mean for
  DSEC, mean over the supervision times for MultiFlow.
- ``epe``: the end-point error, DSEC's masked mean at t = 1 and
  MultiFlow's mean over the supervision times.
- ``AdamW``: each gradient element clamped, then AdamW with decoupled
  weight decay, on the two-phase linear one-cycle learning rate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference.model import flow_at


def voxel_grid(x, y, p, t, valid, t0: float, t1: float, channels: int,
               height: int, width: int) -> torch.Tensor:
    """Events with integer coordinates -> (H, W, C) f32 grid; bins are
    centred at t0 and t1 at the ends. Times are window-relative."""
    val = torch.where(valid, 2.0 * p.double() - 1.0, 0.0)
    tn = (t.double() - t0) / (t1 - t0) * (channels - 1)
    tf = torch.floor(tn)
    grid = torch.zeros(height * width * channels, dtype=torch.float64,
                       device=x.device)
    pix = y.long() * width + x.long()
    for b in (tf, tf + 1.0):
        keep = valid & (b >= 0) & (b < channels)
        w = val * (1.0 - (b - tn).abs())
        grid.index_add_(0, (pix * channels + b.long())[keep], w[keep])
    return grid.float().reshape(height, width, channels)


def dsec_loss(preds: Sequence[torch.Tensor], flow, valid,
              gamma: float) -> torch.Tensor:
    m = valid.float()
    n = len(preds)
    loss = 0.0
    for i, p in enumerate(preds):
        err = (flow_at(p, [1.0])[0] - flow).abs().sum(-1)
        loss = loss + gamma ** (n - 1 - i) * (err * m).sum() / m.sum().clamp(
            min=1.0)
    return loss


def multi_loss(preds: Sequence[torch.Tensor], flows, times: Sequence[float],
               gamma: float) -> torch.Tensor:
    """flows (M, N, H, W, 2) at the M supervision ``times``."""
    n = len(preds)
    loss = 0.0
    for i, p in enumerate(preds):
        err = (flow_at(p, times) - flows).abs().sum(-1).mean(dim=(1, 2, 3))
        loss = loss + gamma ** (n - 1 - i) * err.mean()
    return loss


def epe(pred_at_times, flows, valid=None) -> float:
    """Mean end-point error: pred and flows (M, N, H, W, 2); with valid
    (N, H, W) masked (M = 1)."""
    err = (pred_at_times - flows).square().sum(-1).sqrt()
    if valid is None:
        return float(err.double().mean(dim=(1, 2, 3)).mean())
    m = valid.double()
    return float((err[0].double() * m).sum() / m.sum().clamp(min=1.0))


def onecycle_lr(k: int, max_lr: float, total: int, pct_start: float,
                div: float = 25.0, final_div: float = 1e4) -> float:
    """The two-phase linear one-cycle learning rate at scheduler step k."""
    start = max_lr / div
    end1 = pct_start * total - 1
    if k <= end1:
        return start + (max_lr - start) * k / end1
    pct = (k - end1) / (total - 1 - end1)
    return max_lr + (start / final_div - max_lr) * pct


class AdamW:
    """Clamp + AdamW (b1 0.9, b2 0.999, eps 1e-8) over named f32 leaves,
    learning rate from ``onecycle_lr`` at the step count so far."""

    def __init__(self, params: Dict[str, torch.Tensor], training: Dict):
        self.p = params
        self.cfg = training
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self) -> float:
        s = self.cfg["lr_scheduler"]
        return onecycle_lr(self.t, self.cfg["learning_rate"],
                           s["total_steps"] + 100, s["pct_start"])

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the clamped gradients it used."""
        lr, wd = self.lr(), self.cfg["weight_decay"]
        clip = self.cfg["gradient_clip_val"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        used = {}
        for k, p in self.p.items():
            g = grads[k].clamp(-clip, clip)
            used[k] = g
            p.mul_(1.0 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
        return used


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var",
                          "num_batches_tracked"))


def split_state(sd: Dict[str, torch.Tensor], device):
    """(f32 leaves that train, buffers) of a state dict, on ``device``."""
    leaves = {k: v.to(device, torch.float32).clone().requires_grad_(True)
              for k, v in sd.items() if not is_buffer(k)}
    bufs = {k: v.to(device) for k, v in sd.items() if is_buffer(k)}
    return leaves, bufs


def sorted_median(values: List[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2]
