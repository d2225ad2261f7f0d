"""Bytes the all-level correlation lookup must move, per launch.

The counts of the lookup kernels' bounds (copied from the port's smoke
test, ``patch_cells`` / ``pyramid_bound_bytes`` / ``pyramid_bwd_bound_bytes``,
here over the reference's per-level volumes and coordinates so that a
change to the program cannot move them). Every input byte is counted once
and every output byte once:

- forward, per (level, target) slot: the in-map cells of each query's
  (2r+2)^2 patch in the volume's type, and its (2r+1)^2 outputs; the base
  coordinates once per target (8 bytes a query position);
- backward: per slot the cotangents, the in-map patch cells read from the
  volume, and those cells of the f32 dVol accumulator read and written
  (4 + 4 bytes); the base coordinates once per target and dcoords written
  once per target.

``LookupBytes`` is the reference's ``lookup_hook``: it sums these over
every lookup the reference makes, with the program's volume type.
"""

from __future__ import annotations

import torch

RADIUS = 4
TAPS = (2 * RADIUS + 1) ** 2


def patch_cells(hl: int, wl: int, coords: torch.Tensor,
                radius: int = RADIUS) -> int:
    """Cells of every query's (2r+2)^2 patch inside its hl x wl map, for
    (..., 2) coords at the map's scale."""
    p = 2 * radius + 2
    lo = torch.floor(coords.reshape(-1, 2)) - radius
    nx = torch.clamp(lo[:, 0] + p, max=wl) - torch.clamp(lo[:, 0], min=0)
    ny = torch.clamp(lo[:, 1] + p, max=hl) - torch.clamp(lo[:, 1], min=0)
    return int((nx.clamp(min=0) * ny.clamp(min=0)).sum().item())


def level_bytes(hl: int, wl: int, coords: torch.Tensor, item: int) -> dict:
    """One level's share of a launch: (Tl, N, h1, w1, 2) coords at its
    scale, volume and output elements of ``item`` bytes."""
    cells = patch_cells(hl, wl, coords)
    queries = coords[..., 0].numel()
    return {"fwd": cells * item + queries * TAPS * item,
            "bwd": cells * (item + 8) + queries * TAPS * item}


def base_bytes(targets: int, positions: int) -> dict:
    """The base coordinates: read once per target (forward and backward),
    dcoords written once per target (backward)."""
    coords = targets * positions * 8
    return {"fwd": coords, "bwd": 2 * coords}


class LookupBytes:
    """Sums the per-launch bytes of every lookup the reference makes; one
    launch covers every level of one refinement step, so level 0 starts a
    launch. ``item``: the program's volume type's size in bytes."""

    def __init__(self, item: int):
        self.item = item
        self.launches = 0
        self.fwd = 0
        self.bwd = 0

    def __call__(self, level: int, vol: torch.Tensor, coords: torch.Tensor):
        if level == 0:
            self.launches += 1
            b = base_bytes(coords.shape[0], coords[0, ..., 0].numel())
            self.fwd += b["fwd"]
            self.bwd += b["bwd"]
        b = level_bytes(vol.shape[-2], vol.shape[-1], coords.detach(),
                        self.item)
        self.fwd += b["fwd"]
        self.bwd += b["bwd"]

    def per_launch(self) -> dict:
        """Mean bytes of one forward and one backward launch (empty before
        any lookup)."""
        if not self.launches:
            return {}
        return {"fwd": self.fwd / self.launches,
                "bwd": self.bwd / self.launches}
