"""One MultiFlow2D regenerated sample: events + boundary frames + GT flow
(copy of bflow_tpu/data/multiflow2d/sample.py).

Directory contract:

  seq*/
    events/events.h5        x/y/p/t datasets, t in [0, 1e6) us
    flow/0500000.h5 ...     (H, W, 2) flow from the 400 ms reference time
    images/0400000.png ...  boundary frames at 400 ms and 900 ms

Temporal layout: reference image at 400 ms, target at 900 ms; the merged
voxel grid spans nbins_total = context + correlation - 1 bins, where bin 0
extends (corr-1) bin-spacings *before* the reference so every correlation
window has full support. The context-bins -> (corr bins, bin spacing)
tables are fixed by the dataset generation recipe.

HDF5 goes through bflow_tpu_torch/data/hdf5.py (h5py where installed,
under the data layer's lock, io.h5py_lock) and the frames through cv2, so
items are bit-equal to the JAX package's;
voxel caches share its file names, so either package reuses the other's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from bflow_tpu_torch.data import hdf5
from bflow_tpu_torch.data.io import h5_to_np_array, h5py_lock, np_array_to_h5
from bflow_tpu_torch.data.representations import VoxelGrid

NBINS_CONTEXT2CORR = {6: 4, 11: 7, 21: 13, 41: 25}
NBINS_CONTEXT2DT_US = {6: 100000, 11: 50000, 21: 25000, 41: 12500}

REF_TIME_US = 400 * 1000
TARGET_TIME_US = 900 * 1000


def _downsample_chw(arr: np.ndarray) -> np.ndarray:
    """Bilinear 2x downsample with align_corners=True (torch interpolate
    parity: output pixel i samples input at i * (in-1)/(out-1))."""
    import cv2

    c, h, w = arr.shape
    oh, ow = h // 2, w // 2
    xs = np.arange(ow, dtype=np.float32) * (w - 1) / (ow - 1)
    ys = np.arange(oh, dtype=np.float32) * (h - 1) / (oh - 1)
    mx, my = np.meshgrid(xs, ys)
    out = np.empty((c, oh, ow), np.float32)
    for i in range(c):
        out[i] = cv2.remap(
            arr[i].astype(np.float32), mx, my, cv2.INTER_LINEAR
        )
    return out


def read_rgb(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 RGB: the array imageio reads from an RGB PNG."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None and img.ndim == 3, path
    return img[..., 2::-1]  # cv2 reads BGR(A)


class Sample:
    def __init__(
        self,
        sample_path: Path,
        height: int,
        width: int,
        num_bins_context: int,
        load_voxel_grid: bool = True,
        extended_voxel_grid: bool = True,
        downsample: bool = False,
    ):
        assert sample_path.is_dir(), sample_path
        assert num_bins_context in NBINS_CONTEXT2CORR, num_bins_context

        self.downsample = downsample
        self.num_bins_context = num_bins_context
        self.num_bins_correlation = NBINS_CONTEXT2CORR[num_bins_context]
        # The bin at the reference time is shared between context & corr.
        self.num_bins_total = (
            self.num_bins_context + self.num_bins_correlation - 1
        )
        self.voxel_grid = VoxelGrid(self.num_bins_total, height, width)

        img_dir = sample_path / "images"
        self.img_filepaths = [
            img_dir / (f"{REF_TIME_US}".zfill(7) + ".png"),
            img_dir / (f"{TARGET_TIME_US}".zfill(7) + ".png"),
        ]
        for p in self.img_filepaths:
            assert p.exists(), p
        self.img_ts = [int(p.stem) for p in self.img_filepaths]

        dt = NBINS_CONTEXT2DT_US[num_bins_context]
        self.bin_0_time = self.img_ts[0] - (self.num_bins_correlation - 1) * dt
        assert self.bin_0_time >= 0
        self.bin_target_time = self.img_ts[1]

        self.flow_ref_ts_us = REF_TIME_US
        flow_dir = sample_path / "flow"
        assert flow_dir.is_dir(), flow_dir
        self.flow_filepaths: List[Path] = sorted(
            p for p in flow_dir.iterdir() if p.suffix == ".h5"
        )
        self.flow_ts_us = [int(p.stem) for p in self.flow_filepaths]

        self.event_filepath = sample_path / "events" / "events.h5"
        assert self.event_filepath.exists(), self.event_filepath

        self.version = 1 if extended_voxel_grid else 0
        ds_str = "_downsampled" if downsample else ""
        self.voxel_grid_file = (
            sample_path
            / "events"
            / f"voxel_grid_v{self.version}_{self.num_bins_total}_bins{ds_str}.h5"
        )
        self.load_voxel_grid_from_disk = load_voxel_grid

    # -- ground truth / frames ----------------------------------------------

    def get_flow_gt(self, flow_every_n_ms: int) -> Dict[str, list]:
        assert flow_every_n_ms > 0 and flow_every_n_ms % 10 == 0
        delta_us = flow_every_n_ms * 1000
        out = {"flow": [], "timestamps": []}
        for ts, path in zip(self.flow_ts_us, self.flow_filepaths):
            if (ts - self.flow_ref_ts_us) % delta_us != 0:
                continue
            with h5py_lock(), hdf5.open_file(path) as h5f:
                flow = np.moveaxis(np.asarray(h5f["flow"]), -1, 0)
            if self.downsample:
                flow = _downsample_chw(flow) / 2.0
            out["timestamps"].append(ts)
            out["flow"].append(flow.astype(np.float32))
        return out

    def get_images(self) -> Dict[str, list]:
        images = []
        for path in self.img_filepaths:
            img = np.moveaxis(read_rgb(path), -1, 0)
            if self.downsample:
                img = _downsample_chw(img)
            images.append(img)
        return {"images": images, "timestamps": self.img_ts}

    # -- events ---------------------------------------------------------------

    def _get_events(self, t_start: int, t_end: int):
        assert 0 <= t_start < t_end <= 1000000
        with h5py_lock(), hdf5.open_file(self.event_filepath) as h5f:
            time = np.asarray(h5f["t"])
            lo = np.searchsorted(time, t_start, side="left")
            hi = np.searchsorted(time, t_end, side="right")
            return {
                "x": np.asarray(h5f["x"][lo:hi]),
                "y": np.asarray(h5f["y"][lo:hi]),
                "p": np.asarray(h5f["p"][lo:hi]),
                "t": time[lo:hi],
            }

    def _construct_voxel_grid(self, ts_from: int, ts_to: int) -> np.ndarray:
        if self.version == 1:
            t0, t1 = self.voxel_grid.get_extended_time_window(ts_from, ts_to)
            t0 = max(t0, 0)
            t1 = min(t1, 1000000)
            ev = self._get_events(t0, t1)
            grid = self.voxel_grid.convert(
                ev["x"].astype(np.int16),
                ev["y"].astype(np.int16),
                ev["p"].astype(np.int8),
                ev["t"].astype(np.int32).astype(np.int64),
                ts_from,
                ts_to,
            )
        else:
            ev = self._get_events(ts_from, ts_to)
            grid = self.voxel_grid.convert(
                ev["x"].astype(np.int16),
                ev["y"].astype(np.int16),
                ev["p"].astype(np.int8),
                ev["t"].astype(np.int32).astype(np.int64),
            )
        if self.downsample:
            grid = _downsample_chw(grid)
        return grid

    def get_voxel_grid(self) -> np.ndarray:
        ts_from, ts_to = self.bin_0_time, self.bin_target_time
        if not self.load_voxel_grid_from_disk:
            return self._construct_voxel_grid(ts_from, ts_to)
        if self.voxel_grid_file.exists():
            arr = h5_to_np_array(self.voxel_grid_file)
            if arr is not None:
                return np.squeeze(arr)  # old caches may carry a batch dim
        grid = self._construct_voxel_grid(ts_from, ts_to)
        np_array_to_h5(grid, self.voxel_grid_file)
        return grid

    def voxel_grid_bin_idx_for_reference(self) -> int:
        return self.num_bins_correlation - 1
