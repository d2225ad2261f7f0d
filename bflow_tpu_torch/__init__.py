"""bflow_tpu_torch: RAFT-Spline continuous-time optical flow in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``bflow_tpu`` (the reference, held against it by
the ``tests/test_torch_*.py`` parity tests). It imports no JAX. Entry points
run on the GPU unless the caller asks for the CPU:

    import bflow_tpu_torch as bt
    model = bt.build_model(bt.flagship_config(), device="cuda", seed=0)
    low, up = model(voxel, images, test_mode=True)   # JAX layouts (NHWC)
    flow = up.flow_at(1.0)                           # (N, H, W, 2)

On CPU tensors every kernel wrapper runs its plain PyTorch version.
Training goes through ``python -m bflow_tpu_torch.train``, evaluation
(DSEC or MultiFlow) through ``python -m bflow_tpu_torch.val``, DSEC
submissions through ``python -m bflow_tpu_torch.predict_dsec`` (the JAX
package's CLI overrides; ``main(argv, device="cpu")`` from Python).
"""

from __future__ import annotations

import torch

from bflow_tpu_torch.models import RAFTSpline, RaftSplineConfig, flagship_config
from bflow_tpu_torch.models.extractor import init_weights
from bflow_tpu_torch.ops import BezierCurves

__all__ = ["BezierCurves", "RAFTSpline", "RaftSplineConfig", "build_model",
           "flagship_config", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The requested device; a CUDA device without CUDA raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: RaftSplineConfig, device="cuda",
                seed: int = 0) -> RAFTSpline:
    """RAFTSpline with seeded random weights, in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = RAFTSpline(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
