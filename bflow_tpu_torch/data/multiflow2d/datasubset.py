"""MultiFlow2D train/val subset: one item per sample directory (copy of
bflow_tpu/data/multiflow2d/datasubset.py).

384x512 native, 368x496 crop (halved when downsampling), h/v flip
probability 0.5, optional photometric augmentation, flow/image timestamps
normalized to [0, 1] with the reference frame at 0 and target at 1.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from bflow_tpu_torch.data.augmentor import FlowAugmentor, PhotoAugmentor
from bflow_tpu_torch.data.keys import DataLoading as K, DataSetType
from bflow_tpu_torch.data.multiflow2d.sample import Sample
from bflow_tpu_torch.data.representations import normalize_voxel_grid

ORIG_HW = (384, 512)
CROP_HW = (368, 496)


class Datasubset:
    def __init__(
        self,
        train_or_val_path: Path,
        data_augm: bool,
        num_bins_context: int,
        flow_every_n_ms: int,
        load_voxel_grid: bool = True,
        extended_voxel_grid: bool = True,
        normalize_voxel_grid_: bool = False,
        downsample: bool = False,
        photo_augm: bool = False,
        return_img: bool = True,
        return_ev: bool = True,
        orig_hw=ORIG_HW,
        crop_hw=CROP_HW,
    ):
        assert train_or_val_path.is_dir(), train_or_val_path
        assert train_or_val_path.name in ("train", "val")
        assert return_img, "image-less MultiFlow loading not supported"

        crop = tuple(c // 2 for c in crop_hw) if downsample else crop_hw
        self.delta_ts_flow_ms = flow_every_n_ms
        self.return_ev = return_ev
        self.normalize = normalize_voxel_grid_

        self.spatial_augmentor = (
            FlowAugmentor(crop, h_flip_prob=0.5, v_flip_prob=0.5)
            if data_augm
            else None
        )
        self.photo_augmentor = (
            PhotoAugmentor(
                brightness=0.4,
                contrast=0.4,
                saturation=0.4,
                hue=0.5 / 3.14,
                probability_color=0.2,
                noise_variance_range=(0.001, 0.01),
                probability_noise=0.2,
            )
            if data_augm and photo_augm
            else None
        )

        self.sample_list: List[Sample] = [
            Sample(
                p,
                *orig_hw,
                num_bins_context,
                load_voxel_grid,
                extended_voxel_grid,
                downsample,
            )
            for p in sorted(train_or_val_path.iterdir())
            if p.is_dir()
        ]
        assert self.sample_list, train_or_val_path

    def get_num_bins_context(self) -> int:
        return self.sample_list[0].num_bins_context

    def get_num_bins_correlation(self) -> int:
        return self.sample_list[0].num_bins_correlation

    def get_num_bins_total(self) -> int:
        return self.sample_list[0].num_bins_total

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, index: int):
        return self.get_item(index, np.random.default_rng())

    def get_item(self, index: int, rng: np.random.Generator):
        sample = self.sample_list[index]

        voxel = sample.get_voxel_grid() if self.return_ev else None
        if voxel is not None and self.normalize:
            voxel = normalize_voxel_grid(voxel)

        gt = sample.get_flow_gt(self.delta_ts_flow_ms)
        flows: List[np.ndarray] = gt["flow"]
        flow_ts = gt["timestamps"]

        imgs_with_ts = sample.get_images()
        imgs = imgs_with_ts["images"]
        img_ts = imgs_with_ts["timestamps"]

        ts0, ts1 = img_ts
        assert ts1 > ts0
        img_ts_norm = [(t - ts0) / (ts1 - ts0) for t in img_ts]
        flow_ts_norm = [(t - ts0) / (ts1 - ts0) for t in flow_ts]
        assert img_ts_norm == [0.0, 1.0]
        assert flow_ts_norm[-1] == 1.0
        assert len(flow_ts_norm) == len(flows)

        if self.spatial_augmentor is not None:
            evs = [voxel] if voxel is not None else None
            evs, flows, _, imgs = self.spatial_augmentor(
                rng, evs, flows, None, imgs
            )
            voxel = evs[0] if evs is not None else None
        if self.photo_augmentor is not None:
            imgs = self.photo_augmentor(
                rng, [im.astype(np.uint8) for im in imgs]
            )

        out = {
            K.BIN_META.value: {
                "bin_idx_for_reference": sample.voxel_grid_bin_idx_for_reference(),
                "nbins_context": self.get_num_bins_context(),
                "nbins_correlation": self.get_num_bins_correlation(),
                "nbins_total": self.get_num_bins_total(),
            },
            # (M, H, W, 2) stacked over supervision timestamps, NHWC-last
            K.FLOW.value: np.stack(
                [np.moveaxis(f, 0, -1) for f in flows]
            ).astype(np.float32),
            K.FLOW_TIMESTAMPS.value: np.asarray(flow_ts_norm, np.float32),
            # (2, H, W, 3)
            K.IMG.value: np.stack(
                [np.moveaxis(np.asarray(im), 0, -1) for im in imgs]
            ).astype(np.float32),
            K.IMG_TIMESTAMPS.value: np.asarray(img_ts_norm, np.float32),
            K.DATASET_TYPE.value: int(DataSetType.MULTIFLOW2D),
        }
        if voxel is not None:
            out[K.EV_REPR.value] = np.moveaxis(voxel, 0, -1).astype(
                np.float32
            )
        return out
