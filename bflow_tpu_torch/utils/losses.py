"""L1 sequence losses with optional validity masks.

Counterpart of bflow_tpu/utils/losses.py, same math: per-pixel L1 summed
over the channel axis, masked mean, and RAFT's exponential iteration
weighting gamma^(I-1-i). Layout as in the JAX package: predictions and
targets (N, H, W, C), masks (N, H, W).

In a data-parallel step the JAX loss is a masked mean over the global
batch: sum(err * valid) / max(sum(valid), 1) with both sums global. Each
rank then passes ``count`` (``data_parallel_count``: the global count
over the world size), which makes its loss its share of the global
numerator times the world size; DDP's mean of the ranks' gradients is
then the gradient of the JAX loss. (A mean of the ranks' masked means
would be another loss wherever the ranks' valid shares differ.)
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bflow_tpu_torch.parallel.distributed import all_reduce_sum, process_count


def data_parallel_count(target: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The ``count`` a rank divides its loss by: the global batch's valid
    pixels (without a mask, its pixels: those of ``target`` on every
    rank), summed over the ranks, clamped at 1 and divided by the world
    size. No gradient flows through it, as none flows through JAX's
    denominator (the mask is data)."""
    with torch.no_grad():
        if valid_mask is None:
            local = target.new_full((), float(math.prod(target.shape[:-1])))
        else:
            local = valid_mask.sum(dtype=torch.float32)
        return all_reduce_sum(local).clamp(min=1.0) / process_count()


def l1_loss_masked(source: torch.Tensor, target: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over valid pixels of the channel-summed absolute error; with
    ``count``, the masked sum over ``count`` (module docstring)."""
    if source.shape != target.shape:
        raise ValueError(f"{tuple(source.shape)} vs {tuple(target.shape)}")
    per_pixel = (source - target).abs().sum(dim=-1)
    if valid_mask is not None and valid_mask.shape != per_pixel.shape:
        raise ValueError(f"mask {tuple(valid_mask.shape)} vs "
                         f"{tuple(per_pixel.shape)}")
    if count is not None:
        if valid_mask is not None:
            per_pixel = per_pixel * valid_mask.to(per_pixel.dtype)
        return per_pixel.sum() / count
    if valid_mask is None:
        return per_pixel.mean()
    m = valid_mask.to(per_pixel.dtype)
    return (per_pixel * m).sum() / m.sum().clamp(min=1.0)


def l1_seq_loss_masked(sources: Sequence[torch.Tensor],
                       target: torch.Tensor,
                       valid_mask: Optional[torch.Tensor] = None,
                       gamma: float = 0.8,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exponentially weighted sum over refinement iterations (RAFT)."""
    n = len(sources)
    if n == 0:
        raise ValueError("no predictions")
    loss = 0.0
    for i, src in enumerate(sources):
        loss = loss + gamma ** (n - i - 1) * l1_loss_masked(
            src, target, valid_mask, count)
    return loss


def l1_multi_seq_loss_masked(
    sources: Sequence[Sequence[torch.Tensor]],
    targets: Sequence[torch.Tensor],
    valid_masks: Optional[Sequence[torch.Tensor]] = None,
    gamma: float = 0.8,
    counts: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Refinement iterations (outer) x supervision times (inner): per
    iteration the mean over the supervision times, then the exponential
    iteration weighting; ``counts``: one ``count`` per supervision
    time."""
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
            count = counts[ti] if counts is not None else None
            i_loss = i_loss + l1_loss_masked(src, targets[ti], mask, count)
        i_loss = i_loss / len(per_iter)
        loss = loss + gamma ** (num_iters - it - 1) * i_loss
    return loss
