"""Validation entry point of the port (counterpart of the JAX package's
val.py), on the GPU unless the caller asks for the CPU:

  python -m bflow_tpu_torch.val dataset=dsec model=raft-spline \
      dataset.path=<DIR> checkpoint=<CKPT> batch_size=8 \
      [+experiment/dsec/raft_spline=E_I_LU4_BD2_lowpyramid] [model.*=...]
  python -m bflow_tpu_torch.val dataset=multiflow_regen model=raft-spline \
      dataset.path=<DIR> checkpoint=<CKPT> \
      +experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid

  from bflow_tpu_torch import val
  val.main([...overrides...], device="cpu")

The config tree is the JAX package's (bflow_tpu_torch/config, a
byte-identical copy); the device is an argument, not a config key.
`checkpoint` is a port checkpoint (`train.CheckpointManager`'s files) or
a reference Lightning `.ckpt` (its `net.*` keys are the port's names).
The model is built from the config and the checkpoint loaded into it;
batches come from the port's data layer through the Loader's pinned,
non-blocking hand-off; metrics go to ./validation_logs/val_metrics.csv
and are printed at the end. MultiFlow evaluates its val split at the
dataset's supervision timestamps (the val/*_multi metrics); DSEC has no
held-out validation split: its metrics are train-split inference without
augmentation.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict


def main(argv=None, device="cuda") -> Dict[str, Any]:
    """Runs the validation; returns the logged metrics, the model config,
    the fields evaluated, the loop's seconds and the share of them spent
    waiting for the loader."""
    from bflow_tpu_torch import resolve_device
    from bflow_tpu_torch.cli import (
        CONFIG_DIR,
        backfill_correlation_bins,
        build_provider,
        model_config_from,
        supervision_timestamps,
    )
    from bflow_tpu_torch.confsys import compose
    from bflow_tpu_torch.data.keys import DataLoading as K
    from bflow_tpu_torch.data.loader import Loader
    from bflow_tpu_torch.loggers.csv_logger import CSVLogger
    from bflow_tpu_torch.models import RAFTSpline
    from bflow_tpu_torch.train import TaskConfig, make_eval_step
    from bflow_tpu_torch.train.checkpoint import restore_weights_only
    from bflow_tpu_torch.utils.metrics import MetricBank

    dev = resolve_device(device)
    overrides = list(argv if argv is not None else sys.argv[1:])
    config = compose(CONFIG_DIR, "val", overrides)

    provider = build_provider(config)
    backfill_correlation_bins(config, provider)
    cfg = model_config_from(config)

    val_ds = provider.get_val_dataset()
    if config["dataset"]["name"] == "multiflow_regen":
        task = TaskConfig(
            dataset="multiflow2d",
            supervision_timestamps=supervision_timestamps(val_ds),
        )
    else:
        task = TaskConfig(dataset="dsec")
        # The reference raises NotImplementedError here (no DSEC val split
        # with ground truth); the provider serves the TRAIN sequences
        # without augmentation instead. Label the output so nobody
        # mistakes these numbers for held-out validation.
        print(
            "NOTE: DSEC has no held-out validation split — metrics "
            "below are TRAIN-SPLIT inference (no augmentation), not "
            "held-out validation."
        )

    # keep every sample: the tail batch has its own size
    loader = Loader(
        val_ds,
        batch_size=int(config["batch_size"]),
        shuffle=False,
        num_workers=int(config["hardware"].get("num_workers", 4)),
        drop_last=False,
        device=dev,
    )

    model = RAFTSpline(cfg)
    restore_weights_only(config["checkpoint"], model)
    model = model.to(dev).eval()
    print(f"loaded checkpoint: {config['checkpoint']}")

    eval_step = make_eval_step(model, task)
    bank = MetricBank()
    logger = CSVLogger("./validation_logs", "val_metrics")

    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        metrics, _, _ = eval_step(batch)
        bank.update(metrics)  # reads the values back: one sync per batch
        n += batch[K.EV_REPR.value].shape[0]
    dt = time.perf_counter() - t0

    results = bank.compute()
    results["fields_per_sec"] = n / dt
    logger.log(results, 0)
    logger.finalize()
    print("== validation results ==")
    for k, v in sorted(results.items()):
        print(f"{k}: {v:.4f}")
    wait = loader.wait_s / dt
    print(f"fields: {n} in {dt:.3f} s, loader wait share {wait:.4f}")
    return {"metrics": results, "model_config": cfg, "fields": n,
            "seconds": dt, "loader_wait_share": wait}


if __name__ == "__main__":
    main()
