"""Input padding to x8-divisible spatial sizes, NHWC.

Counterpart of bflow_tpu/utils/padder.py (the reference InputPadder with
its ``requires_padding`` bug fixed, so padding engages for inputs whose
size is not a multiple of 8): replicate (edge) padding split evenly, or
with ``no_top_padding`` every padding row at the bottom (KITTI's mode).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


class InputPadder:
    def __init__(self, min_size: int = 8, no_top_padding: bool = False):
        if min_size <= 0:
            raise ValueError(f"min_size must be positive, got {min_size}")
        self.min_size = min_size
        self.no_top_padding = no_top_padding

    def requires_padding(self, ht: int, wd: int) -> bool:
        return ht % self.min_size != 0 or wd % self.min_size != 0

    def _pads(self, ht: int, wd: int
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        m = self.min_size
        pad_ht = (m - ht % m) % m
        pad_wd = (m - wd % m) % m
        if self.no_top_padding:
            rows = (0, pad_ht)
        else:
            rows = (pad_ht // 2, pad_ht - pad_ht // 2)
        cols = (pad_wd // 2, pad_wd - pad_wd // 2)
        return rows, cols

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., H, W, C); replicate-pad H and W."""
        ht, wd, c = x.shape[-3:]
        rows, cols = self._pads(ht, wd)
        lead = x.shape[:-3]
        # replicate padding of the last two axes of an (B, C, H, W) view
        y = x.reshape(-1, ht, wd, c).permute(0, 3, 1, 2)
        y = F.pad(y, (cols[0], cols[1], rows[0], rows[1]), mode="replicate")
        return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], c)

    def unpad(self, x: torch.Tensor, ht: int, wd: int) -> torch.Tensor:
        """Crop back to the original (ht, wd)."""
        rows, cols = self._pads(ht, wd)
        return x[..., rows[0]:rows[0] + ht, cols[0]:cols[0] + wd, :]
