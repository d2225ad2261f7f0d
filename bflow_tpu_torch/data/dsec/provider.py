"""DSEC dataset provider (copy of bflow_tpu/data/dsec/provider.py).

Walks `<path>/train/*`, builds two-step subsequences with
nbins_correlation := nbins_context, and concatenates them. DSEC has no
validation split with ground truth: the val dataset is the train split
without augmentation. `iter_test_sequences` serves `<path>/test/*` per
recording, for submission writers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from bflow_tpu_torch.data.dsec.sequence import generate_sequence
from bflow_tpu_torch.data.provider import ConcatDataset, DatasetProviderBase


class DsecProvider(DatasetProviderBase):
    def __init__(self, dataset_params: Dict[str, Any], nbins_context: int):
        dataset_path = Path(dataset_params["path"])
        train_path = dataset_path / "train"
        assert dataset_path.is_dir(), dataset_path
        assert train_path.is_dir(), train_path

        self.nbins = nbins_context
        base_args = {
            "num_bins": self.nbins,
            "load_voxel_grid": dataset_params["load_voxel_grid"],
            "extended_voxel_grid": dataset_params["extended_voxel_grid"],
            "normalize": dataset_params["normalize_voxel_grid"],
            "merge_grids": True,
        }
        # testing/mini-dataset hooks; defaults are DSEC's 480x640
        for key in ("height", "width", "crop_hw"):
            if key in dataset_params:
                base_args[key] = dataset_params[key]
        train_args = dict(base_args, data_augm=True)
        self._eval_args = dict(base_args, data_augm=False)

        sequences = []
        for child in sorted(train_path.iterdir()):
            seq = generate_sequence(child, train_args)
            if seq is not None:
                sequences.append(seq)
        assert sequences, f"no flow sequences under {train_path}"
        self.train_dataset = ConcatDataset(sequences)
        self._train_path = train_path

    def get_train_dataset(self):
        return self.train_dataset

    def get_val_dataset(self):
        """DSEC ships no val split; validation-style inference uses the
        train sequences without augmentation (see val entry point)."""
        sequences = []
        for child in sorted(self._train_path.iterdir()):
            seq = generate_sequence(child, self._eval_args)
            if seq is not None:
                sequences.append(seq)
        return ConcatDataset(sequences)

    def iter_test_sequences(self):
        """Yield (sequence_name, dataset) per `<path>/test/*` recording —
        file indices restart per sequence, so submission writers must
        keep sequences separate."""
        from bflow_tpu_torch.data.dsec.test_sequence import generate_test_sequence

        test_path = self._train_path.parent / "test"
        if not test_path.is_dir():
            return
        args = dict(self._eval_args)
        args.pop("data_augm", None)
        for child in sorted(test_path.iterdir()):
            if not child.is_dir():
                continue
            seq = generate_test_sequence(child, args)
            if seq is not None:
                yield child.name, seq

    def get_test_dataset(self):
        """Benchmark-submission loading for `<path>/test/*` (items carry
        no ground-truth flow); None without a test split."""
        sequences = [seq for _, seq in self.iter_test_sequences()]
        return ConcatDataset(sequences) if sequences else None

    def get_nbins_context(self) -> int:
        return self.nbins

    def get_nbins_correlation(self) -> int:
        return self.nbins
