"""Helpers shared by the port's entry points (`train`, `val`,
`predict_dsec`; counterparts of the helpers of the JAX package's
train.py): the config tree, the dataset provider (DSEC or MultiFlow), the
model config from the composed config, MultiFlow's supervision times and
the batch limits.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from bflow_tpu_torch.models.config import RaftSplineConfig

# byte-identical copy of bflow_tpu/config (a CPU test compares the bytes)
CONFIG_DIR = Path(__file__).resolve().parent / "config"


def build_provider(config):
    name = config["dataset"]["name"]
    nbins_ctx = config["model"]["num_bins"]["context"]
    if name == "dsec":
        from bflow_tpu_torch.data.dsec.provider import DsecProvider

        return DsecProvider(config["dataset"], nbins_ctx)
    if name == "multiflow_regen":
        from bflow_tpu_torch.data.multiflow2d.provider import MultiflowProvider

        return MultiflowProvider(config["dataset"], nbins_ctx)
    raise NotImplementedError(name)


def backfill_correlation_bins(config, provider) -> None:
    """Correlation bins left null in the config come from the dataset."""
    if config["model"]["num_bins"].get("correlation") is None:
        config["model"]["num_bins"]["correlation"] = (
            provider.get_nbins_correlation())


def model_config_from(config) -> RaftSplineConfig:
    """RaftSplineConfig from the composed config, with the precision and
    runtime switches of the model group (train.py:model_config_from)."""
    model_cfg = dict(config["model"])
    precision = model_cfg.get("precision") or {}
    return dataclasses.replace(
        RaftSplineConfig.from_dict(model_cfg),
        corr_precision=precision.get("corr", "float32"),
        compute_dtype=precision.get("compute", "float32"),
        lookup_method=model_cfg.get("lookup_method", "auto"),
        remat_updates=bool(model_cfg.get("remat_updates", False)),
        scan_iters=bool(model_cfg.get("scan_iters", False)),
        fuse_corr_conv=bool(model_cfg.get("fuse_corr_conv", False)),
        onehot_from_level=int(model_cfg.get("onehot_from_level", -1)),
        pallas_stem=bool(model_cfg.get("pallas_stem", False)),
        pallas_conv=bool(model_cfg.get("pallas_conv", False)),
    )


def supervision_timestamps(dataset) -> tuple:
    """MultiFlow GT timestamps, read from the first sample (they are
    identical across the dataset by construction)."""
    sample = dataset.sample_list[0]
    gt = sample.get_flow_gt(dataset.delta_ts_flow_ms)
    ts0, ts1 = sample.img_ts
    return tuple((t - ts0) / (ts1 - ts0) for t in gt["timestamps"])


def limit_batches(limit, total: int) -> int:
    if limit is None:
        return total
    if isinstance(limit, float) and limit <= 1.0:
        return int(total * limit)
    return min(int(limit), total)
