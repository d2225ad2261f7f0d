"""DSEC two-step subsequences: contiguous 100 ms flow spans of a sequence
(copy of bflow_tpu/data/dsec/subsequence.py).

Directory contract:

  seq_name/
    flow/forward_timestamps.txt   int64 "from,to" microsecond pairs
    flow/forward/xxxxxx.png       16-bit flow ground truth
    events/left/events.h5         p/x/y/t + ms_to_idx + t_offset
    events/left/rectify_map.h5    (H, W, 2) distorted->rectified lookup
    images/left/ev_inf/xxxxxx.png optional boundary frames

Each item merges the voxel grids of the previous and current 100 ms
windows (dropping the duplicated boundary bin -> 2*nbins-1 channels) and
returns the NHWC batch dict. Voxel grids are cached on disk under the
same directory and file names as the JAX package's, so either package
reuses the other's caches. HDF5 goes through bflow_tpu_torch/data/hdf5.py
(h5py where installed) and images through cv2.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from bflow_tpu_torch.data.augmentor import FlowAugmentor
from bflow_tpu_torch.data import hdf5
from bflow_tpu_torch.data.eventslicer import EventSlicer
from bflow_tpu_torch.data.io import (h5_to_np_array, h5py_lock, load_flow_png,
                                    np_array_to_h5)
from bflow_tpu_torch.data.keys import DataLoading as K, DataSetType
from bflow_tpu_torch.data.representations import VoxelGrid, normalize_voxel_grid

HEIGHT = 480
WIDTH = 640
CROP_HW = (288, 384)


class TwoStepSubSequence:
    def __init__(
        self,
        seq_path: Path,
        forward_flow_timestamps: np.ndarray,
        forward_flow_paths: List[Path],
        data_augm: bool,
        num_bins: int = 15,
        load_voxel_grid: bool = True,
        extended_voxel_grid: bool = True,
        normalize: bool = False,
        merge_grids: bool = True,
        height: int = HEIGHT,
        width: int = WIDTH,
        crop_hw=CROP_HW,
    ):
        assert num_bins >= 1
        assert seq_path.is_dir(), seq_path
        assert len(forward_flow_paths) == forward_flow_timestamps.shape[0]

        self.height, self.width = height, width
        self.num_bins = num_bins
        self.merge_grids = merge_grids
        self.normalize = normalize
        self.augmentor = FlowAugmentor(crop_hw) if data_augm else None
        self.voxel_grid = VoxelGrid(num_bins, self.height, self.width)

        self.forward_flow_timestamps = forward_flow_timestamps
        self.forward_flow_list = list(forward_flow_paths)

        self.ev_dir = seq_path / "events" / "left"
        self.ev_file = self.ev_dir / "events.h5"
        assert self.ev_file.exists(), self.ev_file
        with hdf5.open_file(self.ev_dir / "rectify_map.h5") as h5r:
            self.rectify_map = np.asarray(h5r["rectify_map"])
        assert self.rectify_map.shape == (self.height, self.width, 2)

        img_dir = seq_path / "images" / "left" / "ev_inf"
        self.img_dir: Optional[Path] = img_dir if img_dir.is_dir() else None

        # v1 = extended +/-1-bin event window (boundary-correct grids)
        self.version = 1 if extended_voxel_grid else 0
        self.voxel_grid_dir = (
            self.ev_dir
            / f"voxel_grids_v{self.version}_100ms_forward_{num_bins}_bins"
        )
        self.load_voxel_grid = load_voxel_grid
        if load_voxel_grid:
            self.voxel_grid_dir.mkdir(exist_ok=True)

        self._h5f = None
        self._slicer: Optional[EventSlicer] = None
        self._open_lock = threading.Lock()

    def __getstate__(self):
        # Worker processes receive the dataset by pickle: drop the open h5
        # handle and the (unpicklable) lock; each process reopens lazily.
        state = self.__dict__.copy()
        state["_h5f"] = None
        state["_slicer"] = None
        state["_open_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_lock = threading.Lock()

    # -- low-level access ---------------------------------------------------

    def _ensure_open(self):
        # Threaded-loader safe: without the lock a worker could observe
        # self._h5f set while self._slicer is still None (observed as an
        # AttributeError under 4 workers, scripts/bench_loader.py).
        if self._slicer is None:
            with self._open_lock:
                if self._slicer is None:
                    with h5py_lock():
                        self._h5f = hdf5.open_file(self.ev_file)
                        self._slicer = EventSlicer(self._h5f)

    def _get_events(self, ts_from: int, ts_to: int):
        self._ensure_open()
        start = self._slicer.get_start_time_us()
        final = self._slicer.get_final_time_us()
        assert ts_from > start - 50000, (ts_from, start)
        assert ts_to < final + 50000, (ts_to, final)
        ts_from = max(ts_from, start)
        ts_to = min(ts_to, final)
        assert ts_from < ts_to
        with h5py_lock():
            ev = self._slicer.get_events(ts_from, ts_to)
        assert ev is not None
        x, y = ev["x"], ev["y"]
        assert x.max() < self.width and y.max() < self.height
        xy_rect = self.rectify_map[y, x]
        return xy_rect[:, 0], xy_rect[:, 1], ev["p"], ev["t"]

    def _construct_voxel_grid(self, ts_from: int, ts_to: int) -> np.ndarray:
        if self.version == 1:
            t0, t1 = self.voxel_grid.get_extended_time_window(ts_from, ts_to)
            assert ts_from - t0 < 50000 and t1 - ts_to < 50000
            x, y, p, t = self._get_events(t0, t1)
            return self.voxel_grid.convert(
                x.astype(np.float32),
                y.astype(np.float32),
                p.astype(np.float32),
                t.astype(np.int64),
                ts_from,
                ts_to,
            )
        x, y, p, t = self._get_events(ts_from, ts_to)
        return self.voxel_grid.convert(
            x.astype(np.float32),
            y.astype(np.float32),
            p.astype(np.float32),
            t.astype(np.int64),
        )

    def _get_voxel_grid(self, ts_from: int, ts_to: int, file_index: int):
        if not self.load_voxel_grid:
            return self._construct_voxel_grid(ts_from, ts_to)
        cache = self.voxel_grid_dir / (f"{file_index}".zfill(6) + ".h5")
        if cache.exists():
            arr = h5_to_np_array(cache)
            if arr is not None:
                return arr
        grid = self._construct_voxel_grid(ts_from, ts_to)
        np_array_to_h5(grid, cache)
        return grid

    def _get_image(self, file_idx: int) -> Optional[np.ndarray]:
        if self.img_dir is None:
            return None
        path = self.img_dir / (f"{file_idx}".zfill(6) + ".png")
        if not path.exists():
            return None
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert img is not None, path
        img = img[..., 2::-1]  # BGR -> RGB: the array imageio reads
        return np.moveaxis(img, -1, 0)  # (3, H, W)

    # -- dataset protocol ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.forward_flow_list)

    def __getitem__(self, index: int):
        # Loader workers call get_item with their seeded per-epoch rng;
        # direct indexing falls back to an unseeded one.
        return self.get_item(index, np.random.default_rng())

    def _merged_grid(self, index: int, flow_file_index: int):
        """The item's event representation: previous + current 100 ms
        windows (the t-1 window is synthesized at sequence starts),
        merged along time with the duplicated boundary bin dropped."""
        grids = []
        ts_from = ts_to = None
        for idx in (index, index - 1):
            if 0 <= idx < len(self):
                ts_from, ts_to = self.forward_flow_timestamps[idx]
            else:
                assert idx == index - 1 and ts_from is not None
                dt = ts_to - ts_from
                ts_to = ts_from
                ts_from = ts_from - dt
            file_index = flow_file_index if idx == index else flow_file_index - 2
            grids.append(self._get_voxel_grid(int(ts_from), int(ts_to), file_index))
        grids.reverse()  # [previous, current]

        if self.merge_grids:
            prev, cur = grids
            boundary_gap = np.abs(prev[-1] - cur[0]).max()
            assert boundary_gap < 0.5, boundary_gap
            ev = np.concatenate([prev, cur[1:]], axis=0)  # (2*bins-1, H, W)
            if self.normalize:
                ev = normalize_voxel_grid(ev)
            return ev
        if self.normalize:
            grids = [normalize_voxel_grid(g) for g in grids]
        return np.stack(grids)

    def _boundary_images(self, flow_file_index: int):
        img_ref = self._get_image(flow_file_index)
        if img_ref is None:
            return None
        img_tgt = self._get_image(flow_file_index + 2)
        assert img_tgt is not None
        return [img_ref, img_tgt]

    def get_item(self, index: int, rng: np.random.Generator):
        flow_path = self.forward_flow_list[index]
        flow_file_index = int(flow_path.stem)
        flow_hw2, valid = load_flow_png(flow_path)
        flow = np.moveaxis(flow_hw2, -1, 0)  # (2, H, W)

        ev = self._merged_grid(index, flow_file_index)
        images = self._boundary_images(flow_file_index)

        if self.augmentor is not None:
            evs, flows, valids, imgs = self.augmentor(
                rng, [ev], [flow], [valid], images
            )
            ev, flow, valid = evs[0], flows[0], valids[0]
            images = imgs

        out = {
            K.FLOW.value: np.moveaxis(flow, 0, -1).astype(np.float32),
            K.FLOW_VALID.value: valid.astype(bool),
            K.FILE_INDEX.value: flow_file_index,
            K.EV_REPR.value: np.moveaxis(ev, 0, -1).astype(np.float32),
            K.DATASET_TYPE.value: int(DataSetType.DSEC),
        }
        if images is not None:
            out[K.IMG.value] = np.stack(
                [np.moveaxis(im, 0, -1) for im in images]
            ).astype(np.float32)
        return out
