"""Convex-combination upsampling (RAFT-style), JAX layout (N, H, W, D).

The network predicts, per coarse pixel, a (9, f, f) logit tensor; a
softmax over the 9 spatial neighbours gives convex weights that blend
the 3x3 neighbourhood of the (x f scaled) coarse field into each of the
f x f fine sub-pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted_stack(data: torch.Tensor) -> torch.Tensor:
    """(N, H, W, D) -> (N, H, W, 9, D): 3x3 neighbourhoods, zero padded.
    Neighbour k = ky * 3 + kx is the offset (ky-1, kx-1), F.unfold's
    order for a 3x3 kernel."""
    N, H, W, D = data.shape
    padded = F.pad(data, (0, 0, 1, 1, 1, 1))
    shifts = [padded[:, ky:ky + H, kx:kx + W, :]
              for ky in range(3) for kx in range(3)]
    return torch.stack(shifts, dim=3)


def convex_upsample(data: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Upsample (N, H, W, D) -> (N, factor*H, factor*W, D).

    data holds displacements in coarse pixels and is scaled by ``factor``.
    mask is (N, H, W, 9 * factor**2) logits, channel c = k * factor**2 +
    i * factor + j for neighbour k and sub-pixel (i, j).
    """
    N, H, W, D = data.shape
    f = factor
    assert mask.shape == (N, H, W, 9 * f * f), (mask.shape, data.shape)
    weights = torch.softmax(mask.reshape(N, H, W, 9, f * f), dim=3)
    neigh = _shifted_stack(data * float(f))  # (N, H, W, 9, D)
    up = torch.einsum("nhwks,nhwkd->nhwsd", weights, neigh)
    up = up.reshape(N, H, W, f, f, D).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(N, H * f, W * f, D)
