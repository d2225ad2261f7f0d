"""Bilinear sampling and coordinate grids in pixel coordinates.

Semantics of ``F.grid_sample(align_corners=True, padding_mode='zeros')``
without the normalize/denormalize round trip: bilinear interpolation
between the four integer neighbours, and a neighbour outside the image
contributes exactly zero. Coordinates keep the JAX layout, (x, y) last.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int,
                device=None, dtype=torch.float32) -> torch.Tensor:
    """Pixel-coordinate grid (batch, ht, wd, 2): out[..., 0] = x,
    out[..., 1] = y."""
    ys, xs = torch.meshgrid(
        torch.arange(ht, device=device, dtype=dtype),
        torch.arange(wd, device=device, dtype=dtype),
        indexing="ij",
    )
    grid = torch.stack([xs, ys], dim=-1)
    return grid[None].expand(batch, ht, wd, 2)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at fractional pixel ``coords`` with zero padding.

    Args:
      img:    (B, H, W) values; each batch row is an independent image.
      coords: (B, ..., 2) pixel coordinates, last axis (x, y).

    Returns:
      (B, ...) samples in the promoted type of img and coords.
    """
    if img.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError(f"bad shapes {tuple(img.shape)} {tuple(coords.shape)}")
    B, H, W = img.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    # far-away coordinates are clamped before the integer conversion; at
    # -2 and W both corners stay outside the image, as they were
    x0c = x0.clamp(-2, W).long()
    y0c = y0.clamp(-2, H).long()
    flat = img.reshape(B, H * W)

    def corner(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx.reshape(B, -1)).reshape(idx.shape)
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype))

    v00 = corner(y0c, x0c)
    v01 = corner(y0c, x0c + 1)
    v10 = corner(y0c + 1, x0c)
    v11 = corner(y0c + 1, x0c + 1)
    top = v00 * (1.0 - dx) + v01 * dx
    bot = v10 * (1.0 - dx) + v11 * dx
    return top * (1.0 - dy) + bot * dy
