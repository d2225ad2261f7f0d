"""Static model configuration (copy of bflow_tpu/models/config.py).

A frozen dataclass: every architectural choice (target indices, pyramid
depths, iteration count) is fixed when the model is built. Field
semantics mirror the reference config tree (config/model/raft-spline.yaml
and the experiment overlays). Every option of the JAX config runs in the
port, so a JAX config carries over unchanged (models/raft_spline.py says
what each opt-in mode does here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class RaftSplineConfig:
    # temporal binning
    nbins_context: int = 5
    nbins_correlation: int = 5
    bezier_degree: int = 2
    detach_bezier: bool = False

    # input modalities
    use_events: bool = True
    use_images: bool = True

    # event correlation: which context-bin indices are lookup targets and
    # how many pyramid levels each target gets (variable depth).
    ev_target_indices: Tuple[int, ...] = (1, 2, 3, 4)
    ev_levels: Tuple[int, ...] = (1, 1, 1, 4)
    ev_radius: int = 4
    # frame correlation (single target at t=1)
    img_levels: int = 4
    img_radius: int = 4

    # network dims
    hidden_dim: int = 128
    context_dim: int = 128
    feature_dim: int = 256
    motion_dim: int = 128
    feature_norm: str = "instance"
    context_norm: str = "batch"

    # refinement
    iters_train: int = 12
    iters_test: int = 12

    # "bfloat16" fast path or "float32" parity path for the correlation
    # volume. Parameters stay f32 either way.
    corr_precision: str = "float32"
    # correlation window lookup: 'auto' and 'pallas' run the CUDA lookup
    # kernel (its plain version for CPU tensors), 'pallas_q8' the int8
    # kernel on the deep-row levels (inference only), 'gather' the plain
    # version everywhere, 'onehot' the one-hot matmul form (models/corr.py).
    lookup_method: str = "auto"
    # activation dtype for convolutions/GRU ("float32" / "bfloat16").
    compute_dtype: str = "float32"
    # recompute the update block in the backward pass
    remat_updates: bool = False
    # JAX: one rolled lax.scan step (compile time only); the port's loop
    # is the same eager loop either way
    scan_iters: bool = False
    # contract the motion encoder's 1x1 corr conv against the per-level
    # lookups instead of the concatenated corr map (same function)
    fuse_corr_conv: bool = False
    # with a kernel lookup method, levels >= this index take the one-hot
    # lookup (-1: none)
    onehot_from_level: int = -1
    # bf16 compute only (the gates): the 7x7/s2 stems through the stem
    # conv kernel, and the residual / update-block convs through the conv
    # kernels (3x3/s2 through the stem kernel)
    pallas_stem: bool = False
    pallas_conv: bool = False

    def __post_init__(self):
        assert self.nbins_context > 0 and self.nbins_correlation > 0
        assert self.bezier_degree >= 1
        assert self.use_events or self.use_images
        if self.use_events:
            assert len(self.ev_target_indices) > 0
            assert 0 not in self.ev_target_indices
            assert max(self.ev_target_indices) < self.nbins_context
            assert len(self.ev_target_indices) == len(self.ev_levels)
        assert self.ev_radius >= 1 and self.img_radius >= 1

    # -- derived static structure -----------------------------------------

    @property
    def nbins_total(self) -> int:
        return self.nbins_context + self.nbins_correlation - 1

    @property
    def levels_per_target(self) -> Tuple[int, ...]:
        """Pyramid depth per base correlation target (events then frames)."""
        levels: Tuple[int, ...] = ()
        if self.use_events:
            levels += tuple(self.ev_levels)
        if self.use_images:
            levels += (self.img_levels,)
        return levels

    @property
    def num_targets(self) -> int:
        return len(self.levels_per_target)

    @property
    def radius(self) -> int:
        # The reference hardcodes lookup radius 4 for all targets.
        return 4

    @property
    def corr_planes(self) -> int:
        """Motion-encoder correlation input channels: sum over targets of
        levels * (2r+1)^2."""
        win = (2 * self.radius + 1) ** 2
        return sum(lvl * win for lvl in self.levels_per_target)

    @property
    def lookup_timestamps(self) -> Tuple[float, ...]:
        """Static per-target Bezier evaluation times (events, then t=1 for
        frames)."""
        ts: Tuple[float, ...] = ()
        if self.use_events:
            dt = 1.0 / (self.nbins_context - 1)
            ts += tuple(dt * idx for idx in self.ev_target_indices)
        if self.use_images:
            ts += (1.0,)
        return ts

    # -- construction from the YAML config tree ----------------------------

    @classmethod
    def from_dict(cls, model_cfg: Dict[str, Any]) -> "RaftSplineConfig":
        corr = model_cfg["correlation"]
        use_images = bool(model_cfg["use_boundary_images"])
        use_events = bool(model_cfg["use_events"])
        ev = corr.get("ev") or {}
        img = corr.get("img") or {}
        kwargs: Dict[str, Any] = dict(
            nbins_context=int(model_cfg["num_bins"]["context"]),
            nbins_correlation=int(model_cfg["num_bins"]["correlation"]),
            bezier_degree=int(model_cfg["bezier_degree"]),
            detach_bezier=bool(model_cfg["detach_bezier"]),
            use_events=use_events,
            use_images=use_images,
            hidden_dim=int(model_cfg["hidden"]["dim"]),
            context_dim=int(model_cfg["context"]["dim"]),
            context_norm=str(model_cfg["context"]["norm"]),
            feature_dim=int(model_cfg["feature"]["dim"]),
            feature_norm=str(model_cfg["feature"]["norm"]),
            motion_dim=int(model_cfg["motion"]["dim"]),
            iters_train=int(model_cfg["num_iter"]["train"]),
            iters_test=int(model_cfg["num_iter"]["test"]),
        )
        if use_events:
            kwargs["ev_target_indices"] = tuple(
                int(i) for i in ev["target_indices"])
            kwargs["ev_levels"] = tuple(int(v) for v in ev["levels"])
            radii = ev.get("radius")
            if radii:
                kwargs["ev_radius"] = (
                    int(radii[0]) if isinstance(radii, (list, tuple))
                    else int(radii))
        if use_images:
            kwargs["img_levels"] = int(img["levels"])
            kwargs["img_radius"] = int(img["radius"])
        return cls(**kwargs)


def flagship_config() -> RaftSplineConfig:
    """DSEC events+images (E_I_LU4_BD2_lowpyramid) at 15 context bins,
    bf16 correlation and compute, fused convc1: the configuration that
    the JAX package's bench and entry point time."""
    return RaftSplineConfig(
        nbins_context=15,
        nbins_correlation=15,
        bezier_degree=2,
        detach_bezier=False,
        use_events=True,
        use_images=True,
        ev_target_indices=(1, 2, 3, 4),
        ev_levels=(1, 1, 1, 4),
        img_levels=4,
        img_radius=4,
        corr_precision="bfloat16",
        compute_dtype="bfloat16",
        fuse_corr_conv=True,
    )
