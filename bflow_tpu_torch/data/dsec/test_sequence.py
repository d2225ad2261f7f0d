"""DSEC *test*-split loading, the benchmark-submission path (copy of
bflow_tpu/data/dsec/test_sequence.py).

Test sequences ship `flow/forward_timestamps.txt` + events (+ optional
frames) but no flow ground truth; items carry the voxel grids / images /
file index only, so predictions can be written out per timestamp pair for
submission.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from bflow_tpu_torch.data.dsec.subsequence import TwoStepSubSequence
from bflow_tpu_torch.data.keys import DataLoading as K, DataSetType
from bflow_tpu_torch.data.provider import ConcatDataset


class TestSubSequence(TwoStepSubSequence):
    """Two-step windows without ground-truth flow."""

    def __init__(self, seq_path, forward_flow_timestamps, file_indices,
                 **kwargs):
        # Parent wants flow paths; test split has none. Provide the file
        # indices directly and skip everything GT-related.
        self._file_indices = list(file_indices)
        super().__init__(
            seq_path,
            forward_flow_timestamps,
            forward_flow_paths=[Path(f"{i:06d}.png") for i in file_indices],
            data_augm=False,
            **kwargs,
        )
        self.forward_flow_list = [None] * len(file_indices)  # no GT

    def __len__(self) -> int:
        return len(self._file_indices)

    def get_item(self, index: int, rng: np.random.Generator) -> Dict:
        file_index = self._file_indices[index]
        ev = self._merged_grid(index, file_index)

        out = {
            K.FILE_INDEX.value: file_index,
            K.EV_REPR.value: np.moveaxis(ev, 0, -1).astype(np.float32),
            K.DATASET_TYPE.value: int(DataSetType.DSEC),
        }
        images = self._boundary_images(file_index)
        if images is not None:
            out[K.IMG.value] = np.stack(
                [np.moveaxis(im, 0, -1) for im in images]
            ).astype(np.float32)
        return out


def generate_test_sequence(seq_path: Path, args: Dict) -> Optional[ConcatDataset]:
    ts_file = seq_path / "flow" / "forward_timestamps.txt"
    if not ts_file.is_file():
        return None
    # test timestamp files may carry a file-index third column
    raw = np.loadtxt(str(ts_file), dtype="int64", delimiter=",", ndmin=2)
    if raw.shape[1] >= 3:
        timestamps = raw[:, :2]
        file_indices = raw[:, 2].tolist()
    else:
        timestamps = raw
        file_indices = [2 * i for i in range(raw.shape[0])]

    is_start = np.concatenate(([True], timestamps[1:, 0] != timestamps[:-1, 1]))
    starts = list(np.where(is_start)[0]) + [timestamps.shape[0]]
    subs = [
        TestSubSequence(
            seq_path, timestamps[a:b], file_indices[a:b], **args
        )
        for a, b in zip(starts[:-1], starts[1:])
    ]
    return ConcatDataset(subs)
