"""DSEC sequence discovery: split at flow-timestamp discontinuities (copy of
bflow_tpu/data/dsec/sequence.py).

`forward_timestamps.txt` holds (from_us, to_us) pairs; wherever
from[i+1] != to[i] the recording has a gap, so the sequence is split into
contiguous subsequences (each needing a valid "previous window").
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bflow_tpu_torch.data.dsec.subsequence import TwoStepSubSequence
from bflow_tpu_torch.data.provider import ConcatDataset


def sequence_has_flow(seq_path: Path) -> bool:
    return (seq_path / "flow").is_dir()


def generate_sequence(seq_path: Path, args: Dict) -> Optional[ConcatDataset]:
    """All contiguous subsequences of one recording, concatenated."""
    if not sequence_has_flow(seq_path):
        return None
    flow_dir = seq_path / "flow"
    ts_file = flow_dir / "forward_timestamps.txt"
    assert ts_file.is_file(), ts_file
    timestamps = np.loadtxt(str(ts_file), dtype="int64", delimiter=",")
    if timestamps.ndim == 1:
        timestamps = timestamps[None]
    assert timestamps.shape[1] == 2

    forward_dir = flow_dir / "forward"
    assert forward_dir.is_dir(), forward_dir
    flow_paths: List[Path] = sorted(
        p for p in forward_dir.iterdir() if p.name.endswith(".png")
    )
    assert len(flow_paths) == timestamps.shape[0], (
        len(flow_paths), timestamps.shape,
    )

    is_start = np.concatenate(
        ([True], timestamps[1:, 0] != timestamps[:-1, 1])
    )
    starts = list(np.where(is_start)[0]) + [len(flow_paths)]

    subsequences = [
        TwoStepSubSequence(
            seq_path,
            timestamps[a:b],
            flow_paths[a:b],
            **args,
        )
        for a, b in zip(starts[:-1], starts[1:])
    ]
    return ConcatDataset(subsequences)
