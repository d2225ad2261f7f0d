"""MultiFlow2D dataset provider (train + val splits); a copy of
bflow_tpu/data/multiflow2d/provider.py."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from bflow_tpu_torch.data.multiflow2d.datasubset import Datasubset
from bflow_tpu_torch.data.provider import DatasetProviderBase


class MultiflowProvider(DatasetProviderBase):
    def __init__(self, dataset_params: Dict[str, Any], nbins_context: int):
        dataset_path = Path(dataset_params["path"])
        train_path = dataset_path / "train"
        val_path = dataset_path / "val"
        assert train_path.is_dir(), train_path
        assert val_path.is_dir(), val_path

        base_args = {
            "num_bins_context": nbins_context,
            "load_voxel_grid": dataset_params["load_voxel_grid"],
            "normalize_voxel_grid_": dataset_params["normalize_voxel_grid"],
            "extended_voxel_grid": dataset_params["extended_voxel_grid"],
            "flow_every_n_ms": dataset_params["flow_every_n_ms"],
            "downsample": dataset_params["downsample"],
            "photo_augm": dataset_params["photo_augm"],
            "return_img": dataset_params.get("return_img", True),
            "return_ev": dataset_params.get("return_ev", True),
        }
        # testing/mini-dataset hooks; defaults are the MultiFlow2D native
        # 384x512 resolution and 368x496 crop
        if "orig_hw" in dataset_params:
            base_args["orig_hw"] = tuple(dataset_params["orig_hw"])
        if "crop_hw" in dataset_params:
            base_args["crop_hw"] = tuple(dataset_params["crop_hw"])
        self.train_dataset = Datasubset(
            train_path, data_augm=True, **base_args
        )
        self.val_dataset = Datasubset(val_path, data_augm=False, **base_args)

        self.nbins_context = self.train_dataset.get_num_bins_context()
        self.nbins_correlation = self.train_dataset.get_num_bins_correlation()
        assert (
            self.val_dataset.get_num_bins_context() == self.nbins_context
        )

    def get_train_dataset(self):
        return self.train_dataset

    def get_val_dataset(self):
        return self.val_dataset

    def get_test_dataset(self):
        raise NotImplementedError  # reference parity

    def get_nbins_context(self) -> int:
        return self.nbins_context

    def get_nbins_correlation(self) -> int:
        return self.nbins_correlation
