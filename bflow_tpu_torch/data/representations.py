"""Event-stream -> voxel-grid rasterization (host path, vectorized NumPy);
a copy of bflow_tpu/data/representations.py, bit-equal to it.

Bilinear-in-time scatter for integer pixel coordinates, trilinear x-y-t
scatter for float (rectified) coordinates, polarity mapped to +/-1, by
`np.add.at` over precomputed corner index/weight arrays.

The on-device counterpart (same math, one scatter-add over padded event
tensors) is bflow_tpu_torch/ops/voxelize.py; this host version is the
cache builder and the oracle for it.

Grids are built (C, H, W) — the voxel caches' on-disk layout — and
transposed to NHWC at batch assembly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def normalize_voxel_grid(voxel_grid: np.ndarray) -> np.ndarray:
    """Zero-mean / unit-std over the *nonzero* voxels only (in place)."""
    mask = voxel_grid != 0
    if mask.any():
        vals = voxel_grid[mask]
        mean = vals.mean()
        std = vals.std()
        if std > 0:
            voxel_grid[mask] = (vals - mean) / std
        else:
            voxel_grid[mask] = vals - mean
    return voxel_grid


class VoxelGrid:
    def __init__(self, channels: int, height: int, width: int):
        assert channels > 1 and height > 1 and width > 1
        self.nb_channels = channels
        self.height = height
        self.width = width

    def get_extended_time_window(self, t0_center: int, t1_center: int):
        """Window extended by one bin spacing on both sides, so boundary
        bins receive their full bilinear support ("v1" grids)."""
        dt = self._get_dt(t0_center, t1_center)
        return math.floor(t0_center - dt), math.ceil(t1_center + dt)

    def _get_dt(self, t0_center: int, t1_center: int) -> float:
        assert t1_center > t0_center
        return (t1_center - t0_center) / (self.nb_channels - 1)

    def _normalize_time(self, time: np.ndarray, t0_center, t1_center):
        return (
            (time.astype(np.float64) - t0_center)
            / (t1_center - t0_center)
            * (self.nb_channels - 1)
        )

    def convert(
        self,
        x: np.ndarray,
        y: np.ndarray,
        pol: np.ndarray,
        time: np.ndarray,
        t0_center: Optional[int] = None,
        t1_center: Optional[int] = None,
    ) -> np.ndarray:
        """Rasterize events into a (C, H, W) float32 grid.

        Integer x/y: bilinear in time only. Float x/y (rectified):
        trilinear in x, y, t. Polarity in {0, 1} -> {-1, +1}.
        """
        assert x.shape == y.shape == pol.shape == time.shape
        assert x.ndim == 1
        assert np.issubdtype(time.dtype, np.integer)

        ch, ht, wd = self.nb_channels, self.height, self.width
        grid = np.zeros(ch * ht * wd, dtype=np.float32)
        if x.size == 0:
            return grid.reshape(ch, ht, wd)

        t0_center = int(time[0]) if t0_center is None else t0_center
        t1_center = int(time[-1]) if t1_center is None else t1_center
        t_norm = self._normalize_time(time, t0_center, t1_center)
        t_floor = np.floor(t_norm).astype(np.int64)
        value = (2.0 * pol.astype(np.float32) - 1.0).astype(np.float64)

        int_xy = np.issubdtype(x.dtype, np.integer)
        if int_xy:
            assert np.issubdtype(y.dtype, np.integer)
            xi = x.astype(np.int64)
            yi = y.astype(np.int64)
            for tlim in (t_floor, t_floor + 1):
                m = (tlim >= 0) & (tlim < ch)
                w = value * (1.0 - np.abs(tlim - t_norm))
                idx = ht * wd * tlim + wd * yi + xi
                np.add.at(grid, idx[m], w[m].astype(np.float32))
        else:
            xf = x.astype(np.float64)
            yf = y.astype(np.float64)
            x0 = np.floor(xf).astype(np.int64)
            y0 = np.floor(yf).astype(np.int64)
            for xlim in (x0, x0 + 1):
                wx = 1.0 - np.abs(xlim - xf)
                for ylim in (y0, y0 + 1):
                    wy = 1.0 - np.abs(ylim - yf)
                    for tlim in (t_floor, t_floor + 1):
                        wt = 1.0 - np.abs(tlim - t_norm)
                        m = (
                            (xlim >= 0)
                            & (xlim < wd)
                            & (ylim >= 0)
                            & (ylim < ht)
                            & (tlim >= 0)
                            & (tlim < ch)
                        )
                        w = value * wx * wy * wt
                        idx = ht * wd * tlim + wd * ylim + xlim
                        np.add.at(grid, idx[m], w[m].astype(np.float32))

        return grid.reshape(ch, ht, wd)
