"""Update block: motion encoder, separable conv GRU, prediction heads.

Counterpart of bflow_tpu/models/update.py, NCHW. The Bezier parameter
channels fed to the convolutions are dimension-major (x_P1..x_Pn,
y_P1..y_Pn), as in the reference, so imported weights line up channel for
channel. The correlation input keeps the JAX layout: one (N, h1, w1, C)
map (the lookup kernel's output, which the fused convc1 of
fuse_corr_conv reads as its input matrix), or the per-level
(Tl, N, h1, w1, (2r+1)^2) lookups.

Under ``pallas_conv`` the convs follow the JAX package's dispatch
(bflow_tpu/models/update.py): every conv takes the conv3x3 kernel where
the copied JAX gate passes (models/extractor.py:conv2d), convc2,
convf2, conv, mask_0 and bezier_head.conv1 with the ReLU fused, and the
GRU runs the JAX package's fused gate decomposition. The kernels' outputs
are channels-last in memory; the concatenations, gates and slices between
them keep that layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bflow_tpu_torch.kernels import corr_proj
from bflow_tpu_torch.kernels.conv_common import cached
from bflow_tpu_torch.models.config import RaftSplineConfig
from bflow_tpu_torch.models.extractor import Conv2d, conv2d


def compute_dtype_of(cfg: RaftSplineConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


class BezierHead(nn.Module):
    def __init__(self, input_dim: int, bezier_degree: int,
                 hidden_dim: int = 256, compute_dtype=None,
                 use_kernel: bool = False):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1,
                            compute_dtype=compute_dtype,
                            use_kernel=use_kernel, relu=True)
        # conv2's fan-out (2 * degree) fails the kernel's gate
        self.conv2 = Conv2d(hidden_dim, 2 * bezier_degree, 3, padding=1,
                            compute_dtype=compute_dtype,
                            use_kernel=use_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class SepConvGRU(nn.Module):
    """Two-pass gated GRU with separable 1x5 / 5x1 convolutions, with the
    reference's per-gate parameters (convz1, convr1, convq1, ...).

    ``use_kernel`` (pallas_conv) takes the JAX package's fused form: per
    pass one conv over [h, x] with the kernel [kz | kr | kq with its
    h-rows zeroed] gives [z | r | q_x], and one conv over r*h with kq's
    h-rows gives the rest of q; each goes through the kernel where the
    gate passes on its own shape."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 compute_dtype=None, use_kernel: bool = False):
        super().__init__()
        cin = hidden_dim + input_dim
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", Conv2d(
                    cin, hidden_dim, k, padding=pad,
                    compute_dtype=compute_dtype))

    def _fused_params(self, suffix: str):
        """The fused pass's two (weight, bias) pairs. Where no gradient
        can be asked for they are made once per parameter value
        (conv_common.cached), so the kernels' prepared-weight cache sees
        the same tensors again; under autograd they are built in the
        graph."""
        d = self.hidden_dim
        cz, cr, cq = (getattr(self, f"conv{g}{suffix}") for g in "zrq")
        sources = (cz.weight, cr.weight, cq.weight, cz.bias, cr.bias,
                   cq.bias)

        def make():
            kq_x = torch.cat([torch.zeros_like(cq.weight[:, :d]),
                              cq.weight[:, d:]], dim=1)
            return (torch.cat([cz.weight, cr.weight, kq_x]),
                    torch.cat([cz.bias, cr.bias, cq.bias]),
                    cq.weight[:, :d].contiguous(), torch.zeros_like(cq.bias))

        if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
            return make()
        return cached(("gru_fused", suffix), sources, make)

    def _fused_pass(self, h: torch.Tensor, x: torch.Tensor,
                    suffix: str) -> torch.Tensor:
        d, cdt, uk = self.hidden_dim, self.compute_dtype, self.use_kernel
        pad = getattr(self, f"convq{suffix}").padding
        w_zrq, b_zrq, w_qh, b_qh = self._fused_params(suffix)
        zrq = conv2d(torch.cat([h, x], dim=1), w_zrq, b_zrq, 1, pad, cdt, uk)
        z = torch.sigmoid(zrq[:, :d])
        r = torch.sigmoid(zrq[:, d:2 * d])
        q_h = conv2d(r * h.to(r.dtype), w_qh, b_qh, 1, pad, cdt, uk)
        q = torch.tanh(q_h + zrq[:, 2 * d:])
        return (1.0 - z) * h.to(z.dtype) + z * q

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel:
            for suffix in "12":
                h = self._fused_pass(h, x, suffix)
            return h
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            h = h.to(r.dtype)
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x.to(r.dtype)], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RaftSplineConfig):
        super().__init__()
        cdt = compute_dtype_of(cfg)
        uk = cfg.pallas_conv
        bz = 2 * cfg.bezier_degree
        self.corr_planes = cfg.corr_planes
        self.compute_dtype = cdt
        self.fuse = cfg.fuse_corr_conv
        # convc1 holds the parameters only: forward contracts them itself
        self.convc1 = Conv2d(cfg.corr_planes, 256, 1, compute_dtype=cdt)
        self.convc2 = Conv2d(256, 192, 3, padding=1, compute_dtype=cdt,
                             use_kernel=uk, relu=True)
        # the ReLU after convf1 is not fused, as in the JAX package
        self.convf1 = Conv2d(bz, 128, 7, padding=3, compute_dtype=cdt,
                             use_kernel=uk)
        self.convf2 = Conv2d(128, 64, 3, padding=1, compute_dtype=cdt,
                             use_kernel=uk, relu=True)
        self.conv = Conv2d(192 + 64, cfg.motion_dim - bz, 3, padding=1,
                           compute_dtype=cdt, use_kernel=uk, relu=True)

    def _corr_features(
        self, corr: Union[torch.Tensor, List[torch.Tensor]],
    ) -> torch.Tensor:
        """convc1 + ReLU over the correlation lookups -> (N, 256, h1, w1).

        corr is the (N, h1, w1, C) map in (level, target, window) channel
        order, or the per-level (Tl, N, h1, w1, (2r+1)^2) lookups, which
        are concatenated into that map first. With fuse_corr_conv (and for
        the per-level form) the JAX package's fused form: the weights are
        rounded to the compute dtype, the contraction accumulates in f32,
        the f32 bias is added, then one rounding and the ReLU (the
        per-level partial sums, as one product). Otherwise the concat
        form: a 1x1 conv in the compute dtype. The fused form of a bf16 map
        on the card, where autograd records nothing, is the corr_proj
        kernel (kernels/corr_proj.py): the same function, ReLU included,
        without the f32 copies."""
        cdt = self.compute_dtype
        w = self.convc1.weight.reshape(256, self.corr_planes)
        b = self.convc1.bias
        if isinstance(corr, (list, tuple)):
            _, N, h1, w1, _ = corr[0].shape
            x = torch.cat([f.permute(1, 2, 3, 0, 4).reshape(N * h1 * w1, -1)
                           for f in corr], dim=1)
            fused = True
        else:
            N, h1, w1, _ = corr.shape
            x = corr.reshape(N * h1 * w1, -1)
            fused = self.fuse
        if x.shape[1] != self.corr_planes:
            raise ValueError((tuple(x.shape), self.corr_planes))
        if fused:
            if not isinstance(corr, (list, tuple)) and corr_proj.engages(
                    x, self.convc1.weight, b, cdt):
                y = corr_proj.corr_proj(x, self.convc1.weight, b)
                return y.reshape(N, h1, w1, 256).permute(0, 3, 1, 2)
            if cdt is not None:
                w = w.to(cdt)
                x = x.to(cdt)
            y = torch.addmm(b.float(), x.float(), w.float().t())
            y = y.to(w.dtype)
        else:
            if cdt is not None:
                x, w, b = x.to(cdt), w.to(cdt), b.to(cdt)
            y = F.linear(x, w, b)
        return F.relu(y).reshape(N, h1, w1, 256).permute(0, 3, 1, 2)

    def forward(self, bezier: torch.Tensor, corr) -> torch.Tensor:
        cor = self.convc2(self._corr_features(corr))
        bez = self.convf2(F.relu(self.convf1(bezier)))
        out = self.conv(torch.cat([cor, bez], dim=1))
        return torch.cat([out, bezier.to(out.dtype)], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RaftSplineConfig):
        super().__init__()
        cdt = compute_dtype_of(cfg)
        uk = cfg.pallas_conv
        self.encoder = BasicMotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hidden_dim,
                              cfg.context_dim + cfg.motion_dim, cdt, uk)
        self.bezier_head = BezierHead(cfg.hidden_dim, cfg.bezier_degree,
                                      compute_dtype=cdt, use_kernel=uk)
        # mask.0 applies its ReLU itself (fused into the kernel); slot 1
        # keeps the reference checkpoint's names mask.0 / mask.2
        self.mask = nn.Sequential(
            Conv2d(cfg.hidden_dim, 256, 3, padding=1, compute_dtype=cdt,
                   use_kernel=uk, relu=True),
            nn.Identity(),
            Conv2d(256, 64 * 9, 1, compute_dtype=cdt),
        )

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr,
        bezier: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW net, inp and bezier channels -> (new hidden state,
        upsample mask logits (N, 576, h1, w1) f32, Bezier delta
        (N, 2P, h1, w1) f32)."""
        motion = self.encoder(bezier, corr)
        gru_in = torch.cat([inp.to(motion.dtype), motion], dim=1)
        net = self.gru(net, gru_in)
        delta = self.bezier_head(net)
        m = self.mask(net)
        # gradient-balancing scale of the reference; the heads emit f32
        # so the Bezier state and the upsampling stay full precision
        return net, (0.25 * m).float(), delta.float()
