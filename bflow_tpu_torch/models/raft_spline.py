"""RAFT-Spline: recurrent continuous-time flow regression, PyTorch.

Counterpart of bflow_tpu/models/raft_spline.py: the inference forward
(test_mode=True) and the training forward (test_mode=False, every
iteration's upsampled prediction). Inputs keep the JAX layout: the voxel grid is
(N, H, W, nbins_total), the images a (2, N, H, W, 3) stack of the
reference and target boundary frames; the outputs are BezierCurves with
params (N, H, W, P, 2). Inside, activations are NCHW.

Per forward: the encoders and the correlation pyramid run once, then
``iters`` refinement steps each evaluate the Bezier curves at the static
lookup times, look up the correlation windows (one lookup-kernel launch for
every pyramid level, writing the (N, h1, w1, C) map that convc1 reads) and
run the update block; the last step's curves are
convex-upsampled (in training, every step's). With ``remat_updates`` the
update block is recomputed in the backward pass instead of keeping its
activations (torch.utils.checkpoint), as flax's nn.checkpoint does.

Every config switch of the JAX package runs: ``pallas_stem`` and
``pallas_conv`` send the convs their gates pass through the conv kernels
(models/extractor.py, models/update.py), ``lookup_method`` and
``onehot_from_level`` pick the lookup (models/corr.py; ``pallas_q8`` is
inference only and raises under autograd), and ``scan_iters``, which in
JAX rolls the loop into one lax.scan step to cut compile time, runs the
same eager loop here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from bflow_tpu_torch.models.config import RaftSplineConfig
from bflow_tpu_torch.models.corr import (
    METHODS,
    build_pyramid_for_method,
    corr_lookup,
)
from bflow_tpu_torch.models.extractor import BasicEncoder
from bflow_tpu_torch.models.update import BasicUpdateBlock, compute_dtype_of
from bflow_tpu_torch.ops.bezier import BezierCurves
from bflow_tpu_torch.ops.sampler import coords_grid
from bflow_tpu_torch.utils.precision import full_f32
from bflow_tpu_torch.utils.timers import span

def bezier_to_channels(bez: BezierCurves) -> torch.Tensor:
    """(N,H,W,P,2) -> (N,2P,H,W), dimension-major (x_P1..x_Pn, y_P1..)."""
    N, H, W, P, _ = bez.params.shape
    return bez.params.transpose(3, 4).reshape(N, H, W, 2 * P).permute(
        0, 3, 1, 2)


def channels_to_bezier_delta(delta: torch.Tensor, degree: int) -> torch.Tensor:
    """(N,2P,H,W) dimension-major -> (N,H,W,P,2) params layout."""
    N, C, H, W = delta.shape
    assert C == 2 * degree
    return delta.permute(0, 2, 3, 1).reshape(N, H, W, 2, degree).transpose(
        3, 4)


class RAFTSpline(nn.Module):
    def __init__(self, config: RaftSplineConfig):
        super().__init__()
        if config.lookup_method not in METHODS:
            raise ValueError(f"lookup_method={config.lookup_method!r} is "
                             f"not one of {METHODS}")
        self.config = cfg = config
        cdt = compute_dtype_of(cfg)
        kernels = dict(stem_kernel=cfg.pallas_stem,
                       conv_kernel=cfg.pallas_conv)
        ctx_in = 0
        if cfg.use_events:
            self.fnet_ev = BasicEncoder(cfg.nbins_correlation,
                                        cfg.feature_dim, cfg.feature_norm,
                                        cdt, **kernels)
            ctx_in += cfg.nbins_context
        if cfg.use_images:
            self.fnet_img = BasicEncoder(3, cfg.feature_dim,
                                         cfg.feature_norm, cdt, **kernels)
            ctx_in += 3
        self.cnet = BasicEncoder(ctx_in, cfg.hidden_dim + cfg.context_dim,
                                 cfg.context_norm, cdt, **kernels)
        self.update_block = BasicUpdateBlock(cfg)

    def _gen_voxel_grids(
        self, voxel_nchw: torch.Tensor,
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Slice the merged (N, ctx+corr-1, H, W) grid into the per-target
        correlation windows (reference index 0 first) and the context
        grid."""
        cfg = self.config
        if voxel_nchw.shape[1] != cfg.nbins_total:
            raise ValueError(f"voxel grid has {voxel_nchw.shape[1]} bins, "
                             f"the config {cfg.nbins_total}")
        grids = [voxel_nchw[:, idx:idx + cfg.nbins_correlation]
                 for idx in (0, *cfg.ev_target_indices)]
        return grids, voxel_nchw[:, -cfg.nbins_context:]

    def forward(
        self,
        voxel_grid: Optional[torch.Tensor] = None,
        images: Optional[torch.Tensor] = None,
        iters: Optional[int] = None,
        flow_init: Optional[BezierCurves] = None,
        test_mode: bool = False,
    ) -> Union[Tuple[BezierCurves, BezierCurves], List[BezierCurves]]:
        """test_mode=True: (final low-res curves, upsampled curves), under
        torch.no_grad(). test_mode=False: the list of every iteration's
        upsampled curves, for the sequence loss. BatchNorm statistics
        follow the module's train()/eval() mode, as flax's ``train``
        argument does. Runs in full f32 where the config asks for f32
        (utils/precision.py: TF32 off inside, the caller's flags restored
        after), as the JAX package pins its f32 work to HIGHEST; the
        backward of the training forward runs outside this call, so
        train.make_train_step pins its backward itself. Opens the spans
        ``bflow.forward``, ``bflow.encoders``, ``bflow.corr`` and one
        ``bflow.update`` per iteration (utils/timers.py)."""
        with span("forward"), full_f32():
            if test_mode:
                with torch.no_grad():
                    return self._run(voxel_grid, images, iters, flow_init,
                                     test_mode=True)
            return self._run(voxel_grid, images, iters, flow_init,
                             test_mode=False)

    def _encode(self, voxel_grid, images):
        """The feature encoders and the context encoder: (reference and
        target feature maps, the context grid, the GRU's initial state and
        its context input)."""
        cfg = self.config
        cdt = compute_dtype_of(cfg)
        f32_corr = cfg.corr_precision == "float32"
        fmap_refs: List[torch.Tensor] = []
        fmap_tgts: List[torch.Tensor] = []
        context = None

        if cfg.use_events:
            if voxel_grid is None:
                raise ValueError("this config uses events: pass voxel_grid")
            # cast once before slicing, so the slices move bf16
            if cdt is not None:
                voxel_grid = voxel_grid.to(cdt)
            grids, context = self._gen_voxel_grids(
                voxel_grid.permute(0, 3, 1, 2))
            fmaps = self.fnet_ev(grids)
            if f32_corr:
                fmaps = [f.float() for f in fmaps]
            for f in fmaps[1:]:
                fmap_refs.append(fmaps[0])
                fmap_tgts.append(f)

        if cfg.use_images:
            if images is None or images.shape[0] != 2:
                raise ValueError("this config uses frames: pass images as "
                                 "a (2, N, H, W, 3) stack")
            imgs = 2.0 * (images.float() / 255.0) - 1.0
            if cdt is not None:
                imgs = imgs.to(cdt)
            imgs = imgs.permute(0, 1, 4, 2, 3)  # (2, N, 3, H, W)
            f0, f1 = self.fnet_img([imgs[0], imgs[1]])
            if f32_corr:
                f0, f1 = f0.float(), f1.float()
            fmap_refs.append(f0)
            fmap_tgts.append(f1)
            context = (imgs[0] if context is None
                       else torch.cat([context, imgs[0]], dim=1))

        cnet_out = self.cnet(context)
        net = torch.tanh(cnet_out[:, :cfg.hidden_dim])
        inp = torch.relu(cnet_out[:, cfg.hidden_dim:])
        return fmap_refs, fmap_tgts, context, net, inp

    def _run(self, voxel_grid, images, iters, flow_init, test_mode):
        cfg = self.config
        if iters is None:
            iters = cfg.iters_test if test_mode else cfg.iters_train
        if iters < 1:
            raise ValueError(f"iters must be positive, got {iters}")
        if cfg.lookup_method == "pallas_q8" and torch.is_grad_enabled():
            raise RuntimeError(
                "lookup_method='pallas_q8' is inference only (the int8 "
                "lookup has no gradient, as in the JAX package): call with "
                "test_mode=True or under torch.no_grad(), or train with "
                "lookup_method='pallas'")
        with span("encoders"):
            fmap_refs, fmap_tgts, context, net, inp = self._encode(
                voxel_grid, images)

        # (T, N, D, h1, w1) -> (T, N, h1, w1, D)
        with span("corr"):
            pyramid = build_pyramid_for_method(
                torch.stack(fmap_refs).permute(0, 1, 3, 4, 2),
                torch.stack(fmap_tgts).permute(0, 1, 3, 4, 2),
                cfg.levels_per_target, cfg.corr_precision,
                cfg.lookup_method, cfg.onehot_from_level,
            )

        N, _, H, W = context.shape
        if H % 8 or W % 8:
            raise ValueError(f"height and width must be multiples of 8, "
                             f"got {H}x{W}")
        h1, w1 = H // 8, W // 8
        coords0 = coords_grid(N, h1, w1, device=context.device)
        bezier = BezierCurves.zeros(N, h1, w1, cfg.bezier_degree,
                                    device=context.device)
        if flow_init is not None:
            bezier = bezier.delta_update(flow_init.params)

        ts = cfg.lookup_timestamps
        remat = cfg.remat_updates and torch.is_grad_enabled()
        predictions: List[BezierCurves] = []
        for itr in range(iters):
            if cfg.detach_bezier:
                bezier = BezierCurves(bezier.params.detach())
            coords1 = coords0[None] + bezier.flow_at(ts)
            corr = corr_lookup(pyramid, coords1, cfg.radius,
                               method=cfg.lookup_method,
                               precision=cfg.corr_precision,
                               onehot_from_level=cfg.onehot_from_level)
            bez_ch = bezier_to_channels(bezier)
            with span("update"):
                if remat:
                    net, mask, delta = checkpoint(
                        self.update_block, net, inp, corr, bez_ch,
                        use_reentrant=False)
                else:
                    net, mask, delta = self.update_block(net, inp, corr,
                                                         bez_ch)
            bezier = bezier.delta_update(
                channels_to_bezier_delta(delta, cfg.bezier_degree))
            if not test_mode or itr == iters - 1:
                predictions.append(
                    bezier.upsampled(mask.permute(0, 2, 3, 1)))
        if test_mode:
            return bezier, predictions[-1]
        return predictions
