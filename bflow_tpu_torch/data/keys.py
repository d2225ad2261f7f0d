"""Batch schema: the data contract between providers and steps (copy of
bflow_tpu/data/keys.py).

String-valued keys, so batches are plain string-keyed dicts, friendly to
checkpointing and logging.

Array layout: EV_REPR (N, H, W, bins) NHWC; IMG (2, N, H, W, 3) —
boundary frames at reference/target time; FLOW (N, H, W, 2) or (M, N, H,
W, 2) for MultiFlow multi-timestamp supervision; FLOW_VALID (N, H, W).
"""

from enum import Enum


class DataSetType(int, Enum):
    DSEC = 1
    MULTIFLOW2D = 2


class DataLoading(str, Enum):
    FLOW = "flow"
    FLOW_TIMESTAMPS = "flow_timestamps"
    FLOW_VALID = "flow_valid"
    FILE_INDEX = "file_index"
    EV_REPR = "ev_repr"
    BIN_META = "bin_meta"
    IMG = "img"
    IMG_TIMESTAMPS = "img_timestamps"
    DATASET_TYPE = "dataset_type"

    def __str__(self) -> str:  # pragma: no cover
        return self.value
