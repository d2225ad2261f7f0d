"""DSEC benchmark-submission inference of the port (counterpart of the JAX
package's scripts/predict_dsec.py): per-window flow PNGs, on the GPU
unless the caller asks for the CPU.

Runs the model over the DSEC test split (or, without one, the train split
without augmentation) and writes predictions in the DSEC submission
format — 16-bit PNGs named by file index, encoded as value*128 + 2^15 —
one directory per sequence.

  python -m bflow_tpu_torch.predict_dsec dataset.path=<DSEC_DIR> \
      checkpoint=<CKPT> output_dir=./submission \
      [model.num_bins.context=15] [+experiment/...]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Dict


def encode_submission_png(path: Path, flow) -> None:
    import cv2
    import numpy as np

    h, w, _ = flow.shape
    img = np.zeros((h, w, 3), np.uint16)
    img[..., :2] = np.clip(
        flow * 128.0 + 2.0**15, 0, 2**16 - 1
    ).astype(np.uint16)
    img[..., 2] = 1
    ok = cv2.imwrite(str(path), img[..., ::-1])
    assert ok, path


def main(argv=None, device="cuda") -> Dict[str, Any]:
    """Writes the PNGs; returns their count, the output directory, the
    seconds of the prediction loop and fields/s."""
    import torch

    from bflow_tpu_torch import resolve_device
    from bflow_tpu_torch.cli import (
        CONFIG_DIR,
        backfill_correlation_bins,
        build_provider,
        model_config_from,
    )
    from bflow_tpu_torch.confsys import compose
    from bflow_tpu_torch.data.keys import DataLoading as K
    from bflow_tpu_torch.models import RAFTSpline
    from bflow_tpu_torch.train.checkpoint import restore_weights_only

    dev = resolve_device(device)
    overrides = list(argv if argv is not None else sys.argv[1:])
    out_override = [o for o in overrides if o.startswith("output_dir=")]
    output_dir = Path(
        out_override[0].split("=", 1)[1] if out_override else "./submission"
    )
    overrides = [o for o in overrides if not o.startswith("output_dir=")]
    config = compose(CONFIG_DIR, "val",
                     ["dataset=dsec", "model=raft-spline"] + overrides)

    provider = build_provider(config)
    backfill_correlation_bins(config, provider)
    cfg = model_config_from(config)
    model = RAFTSpline(cfg)
    restore_weights_only(config["checkpoint"], model)
    model = model.to(dev).eval()

    # file indices restart per sequence: one output directory each
    sequences = list(provider.iter_test_sequences())
    if not sequences:
        print("no test split found; falling back to train-split inference")
        sequences = [("train_split", provider.get_val_dataset())]

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    total = 0
    t0 = time.perf_counter()
    for seq_name, dataset in sequences:
        seq_dir = output_dir / seq_name
        seq_dir.mkdir(parents=True, exist_ok=True)
        n = len(dataset)
        print(f"{seq_name}: predicting {n} windows")
        for i in range(n):
            item = dataset[i]
            voxel = tensor(item[K.EV_REPR.value])[None]
            images = (
                tensor(item[K.IMG.value])[:, None]
                if cfg.use_images and K.IMG.value in item
                else None
            )
            _, up = model(voxel, images, test_mode=True)
            flow = up.flow_at(1.0)[0].float().cpu().numpy()
            file_index = int(item[K.FILE_INDEX.value])
            encode_submission_png(
                seq_dir / (f"{file_index}".zfill(6) + ".png"), flow
            )
            if (i + 1) % 50 == 0:
                print(f"  {i + 1}/{n}")
        total += n
    dt = time.perf_counter() - t0
    print(f"wrote {total} PNGs to {output_dir} ({total / dt:.3f} fields/s)")
    return {"pngs": total, "output_dir": output_dir, "seconds": dt,
            "fields_per_sec": total / dt}


if __name__ == "__main__":
    main()
