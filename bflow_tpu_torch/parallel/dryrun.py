"""One full data-parallel training step over n ranks.

Counterpart of __graft_entry__.py:dryrun_multichip, with its settings:
the flagship's 15 context bins, event targets (1, 2, 3, 4) at depths
(1, 1, 1, 4) and images, 12 refinement iterations, the kernel lookup
('pallas': the CUDA kernels on a card, their plain versions on the CPU),
64x64 inputs (the deepest pyramid level stays non-degenerate) and a
global batch of n, one sample per rank:

    python -m bflow_tpu_torch.parallel.dryrun [n] [device] [backend]

n CPU processes over gloo under device 'cpu'; one rank per card
(cuda:i, NCCL) under 'cuda'; an explicit 'cuda:k' puts every rank on
card k, over gloo.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from bflow_tpu_torch.parallel import distributed

TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1,
            "lr_scheduler": {"use": True, "total_steps": 100,
                             "pct_start": 0.01}}


def _step(n: int, device=None, backend=None) -> dict:
    import bflow_tpu_torch as bt
    from bflow_tpu_torch.data.keys import DataLoading as K
    from bflow_tpu_torch.parallel.mesh import shard_batch
    from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step

    cfg = bt.RaftSplineConfig(
        nbins_context=15, nbins_correlation=15,
        ev_target_indices=(1, 2, 3, 4), ev_levels=(1, 1, 1, 4),
        use_images=True, iters_train=12, iters_test=12,
        lookup_method="pallas")
    N, H, W = n, 64, 64
    rng = np.random.default_rng(0)
    batch = {
        K.EV_REPR.value: rng.standard_normal(
            (N, H, W, cfg.nbins_total)).astype(np.float32),
        K.IMG.value: rng.integers(0, 255, (2, N, H, W, 3)).astype(
            np.float32),
        K.FLOW.value: rng.standard_normal((N, H, W, 2)).astype(np.float32),
        K.FLOW_VALID.value: np.ones((N, H, W), bool),
    }
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in shard_batch(batch).items()}
    model = bt.build_model(cfg, device, seed=0)
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, TaskConfig("dsec"), state.optimizer,
                           state.scheduler)
    loss = float(step(batch)["train/l1_seq_loss"][0])
    assert np.isfinite(loss), loss
    return {"ranks": distributed.process_count(), "loss": loss,
            "device": str(device), "iters": cfg.iters_train,
            "nbins": cfg.nbins_context, "lookup": cfg.lookup_method}


def dryrun_multichip(n: int, device="cpu", backend: Optional[str] = None,
                     timeout_s: Optional[float] = 600.0) -> dict:
    """Spawn n ranks and run one training step, ended as failed past
    ``timeout_s``; print one 'dryrun_multichip OK' line and return rank
    0's record."""
    out = distributed.spawn(_step, n, args=(n,), device=device,
                            backend=backend, timeout_s=timeout_s)
    print(f"dryrun_multichip OK: {out['ranks']} ranks ({device}), step=1, "
          f"loss={out['loss']:.4f}, lookup_method={out['lookup']}, "
          f"nbins={out['nbins']}, iters={out['iters']}")
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    dryrun_multichip(int(args[0]) if args else 2,
                     args[1] if len(args) > 1 else "cpu",
                     args[2] if len(args) > 2 else None)
