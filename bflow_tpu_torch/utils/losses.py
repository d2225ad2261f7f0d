"""L1 sequence losses with optional validity masks.

Counterpart of bflow_tpu/utils/losses.py, same math: per-pixel L1 summed
over the channel axis, masked mean, and RAFT's exponential iteration
weighting gamma^(I-1-i). Layout as in the JAX package: predictions and
targets (N, H, W, C), masks (N, H, W).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def l1_loss_masked(source: torch.Tensor, target: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Mean over valid pixels of the channel-summed absolute error."""
    if source.shape != target.shape:
        raise ValueError(f"{tuple(source.shape)} vs {tuple(target.shape)}")
    per_pixel = (source - target).abs().sum(dim=-1)
    if valid_mask is None:
        return per_pixel.mean()
    if valid_mask.shape != per_pixel.shape:
        raise ValueError(f"mask {tuple(valid_mask.shape)} vs "
                         f"{tuple(per_pixel.shape)}")
    m = valid_mask.to(per_pixel.dtype)
    return (per_pixel * m).sum() / m.sum().clamp(min=1.0)


def l1_seq_loss_masked(sources: Sequence[torch.Tensor],
                       target: torch.Tensor,
                       valid_mask: Optional[torch.Tensor] = None,
                       gamma: float = 0.8) -> torch.Tensor:
    """Exponentially weighted sum over refinement iterations (RAFT)."""
    n = len(sources)
    if n == 0:
        raise ValueError("no predictions")
    loss = 0.0
    for i, src in enumerate(sources):
        loss = loss + gamma ** (n - i - 1) * l1_loss_masked(
            src, target, valid_mask)
    return loss


def l1_multi_seq_loss_masked(
    sources: Sequence[Sequence[torch.Tensor]],
    targets: Sequence[torch.Tensor],
    valid_masks: Optional[Sequence[torch.Tensor]] = None,
    gamma: float = 0.8,
) -> torch.Tensor:
    """Refinement iterations (outer) x supervision times (inner): per
    iteration the mean over the supervision times, then the exponential
    iteration weighting."""
    num_iters = len(sources)
    if num_iters == 0:
        raise ValueError("no predictions")
    loss = 0.0
    for it, per_iter in enumerate(sources):
        if len(per_iter) != len(targets) or not targets:
            raise ValueError(f"{len(per_iter)} predictions for "
                             f"{len(targets)} targets")
        i_loss = 0.0
        for ti, src in enumerate(per_iter):
            mask = valid_masks[ti] if valid_masks is not None else None
            i_loss = i_loss + l1_loss_masked(src, targets[ti], mask)
        i_loss = i_loss / len(per_iter)
        loss = loss + gamma ** (num_iters - it - 1) * i_loss
    return loss
