"""Run the ACTUAL reference PyTorch network as a numerical oracle (copy of
bflow_tpu/importer/reference_oracle.py; it imports no JAX).

Imports the reference repository's models/raft_spline/raft.py (no code
copied: executed as-is) with two tiny runtime stubs that a plain PyTorch
install lacks: `numba` (jit -> identity; the decorated function is pure
NumPy, reference bezier.py:147-163) and `omegaconf` (only ListConfig
appears, in an isinstance check). Used by bflow_tpu_torch/parity_released.py
to produce checkpoint parity tables.

The reference tree is taken only from BFLOW_REFERENCE_ROOT (the JAX
package's copy reads a fixed path instead): nothing outside this checkout
is read or imported unless that variable names it. Unset, or without
`models/` under it, `reference_available()` is False and the oracle
comparisons skip, as tests/test_reference_parity.py does.
"""

from __future__ import annotations

import os
import pathlib
import sys
import types
from typing import Optional

import numpy as np

_ROOT = os.environ.get("BFLOW_REFERENCE_ROOT")
REFERENCE_ROOT: Optional[pathlib.Path] = pathlib.Path(_ROOT) if _ROOT else None


def reference_available() -> bool:
    return REFERENCE_ROOT is not None and (REFERENCE_ROOT / "models").is_dir()


def load_reference_raft():
    """Import the reference RAFTSpline with numba/omegaconf stubbed."""
    if not reference_available():
        raise FileNotFoundError(
            f"no reference tree (BFLOW_REFERENCE_ROOT={REFERENCE_ROOT})")
    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")

        def jit(*args, **kwargs):
            if len(args) == 1 and callable(args[0]) and not kwargs:
                return args[0]

            def deco(fn):
                return fn

            return deco

        numba.jit = jit
        sys.modules["numba"] = numba
    if "omegaconf" not in sys.modules:
        om = types.ModuleType("omegaconf")

        class ListConfig(list):
            pass

        class DictConfig(dict):
            pass

        om.ListConfig = ListConfig
        om.DictConfig = DictConfig
        sys.modules["omegaconf"] = om
    # Append (not prepend) so the reference's top-level packages never
    # shadow anything resolvable from the repo.
    if str(REFERENCE_ROOT) not in sys.path:
        sys.path.append(str(REFERENCE_ROOT))
    from models.raft_spline.raft import RAFTSpline as TorchRAFTSpline

    return TorchRAFTSpline


def model_params_dict(cfg) -> dict:
    """Reference model_params dict for a RaftSplineConfig (the shape the
    reference hydra tree produces, reference raft.py:15-73)."""
    return {
        "num_bins": {
            "context": cfg.nbins_context,
            "correlation": cfg.nbins_correlation,
        },
        "bezier_degree": cfg.bezier_degree,
        "detach_bezier": cfg.detach_bezier,
        "use_boundary_images": cfg.use_images,
        "use_events": cfg.use_events,
        "correlation": {
            "use_cosine_sim": False,
            "ev": {
                "target_indices": list(cfg.ev_target_indices),
                "levels": list(cfg.ev_levels),
                "radius": [cfg.radius] * len(cfg.ev_target_indices),
            },
            "img": {"levels": cfg.img_levels, "radius": cfg.img_radius},
        },
        "hidden": {"dim": cfg.hidden_dim},
        "context": {"dim": cfg.context_dim, "norm": cfg.context_norm},
        "feature": {"dim": cfg.feature_dim, "norm": cfg.feature_norm},
        "motion": {"dim": cfg.motion_dim},
    }


def torch_forward_flow(
    cfg,
    state_dict: dict,
    voxel_nchw: np.ndarray,
    images_nchw: Optional[list],
    iters: int,
    times=(1.0,),
):
    """Reference forward (eval, f32, test_mode) from a 'net.*' state
    dict; returns {t: flow (N, 2, H, W)} queried from the upsampled
    curve (reference bezier.py:188-199)."""
    import torch

    TorchRAFTSpline = load_reference_raft()
    net = TorchRAFTSpline(model_params_dict(cfg)).eval()
    net.load_state_dict(
        {
            k[len("net."):]: torch.as_tensor(np.asarray(v))
            for k, v in state_dict.items()
            if k.startswith("net.")
        }
    )
    with torch.no_grad():
        images = None
        if cfg.use_images:
            images = [torch.from_numpy(im) for im in images_nchw]
        _, up = net(
            voxel_grid=torch.from_numpy(voxel_nchw),
            images=images,
            iters=iters,
            test_mode=True,
        )
        return {
            t: up.get_flow_from_reference(time=t).numpy() for t in times
        }
