"""RAFT-Spline as plain PyTorch in f32: the benchmark's reference.

Written from the published architecture (RAFT's encoders, all-pairs
correlation pyramid, separable-conv GRU update and convex upsampling, with
the flow as per-pixel Bezier curves, as in uzh-rpg/bflow) over a flat state
dict in the checkpoint's names (``fnet_ev.layer2.0.conv1.weight`` ...). It
imports nothing of the program and holds no kernel: convolutions are
``F.conv2d``, the correlation is ``torch.matmul``, the window lookup is
``F.grid_sample`` (bilinear, zero padding, align_corners), the upsampling
is RAFT's ``F.unfold`` form. TF32 is off for the whole call (``f32``).

Layouts at the boundary are the program's: voxel grids (N, H, W, bins),
frames (2, N, H, W, 3) in 0..255, Bezier control points (N, H, W, P, 2).

``rounding`` names a control's operand rounding (lowp.py): every
convolution and matrix product then reads its inputs and weights rounded.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lowp import rounding as make_rounding

RADIUS = 4  # the lookup radius of every released configuration
EPS = 1e-5  # every norm's epsilon
# volume elements of one grid_sample call: cuDNN's sampler refuses a DSEC
# level 0 at B=16 (1.8e9 elements) and takes one at B=8 (9.2e8), so larger
# volumes are sampled in row blocks (the same values: each output reads
# only its own row)
SAMPLE_ELEMS = 1 << 30


@contextlib.contextmanager
def f32():
    """Both TF32 switches off inside, the caller's restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def bernstein(degree: int, t: float) -> List[float]:
    """Weights of control points P1..Pn at time t (P0 is the origin)."""
    return [math.comb(degree, i) * (1.0 - t) ** (degree - i) * t ** i
            for i in range(1, degree + 1)]


def flow_at(params: torch.Tensor, times: Sequence[float]) -> torch.Tensor:
    """(N, H, W, P, 2) control points -> (T, N, H, W, 2) flows."""
    deg = params.shape[3]
    coeff = torch.tensor(np.array([bernstein(deg, t) for t in times]),
                         dtype=params.dtype, device=params.device)
    return torch.einsum("nhwpd,tp->tnhwd", params, coeff)


def coords_grid(n: int, h: int, w: int, device) -> torch.Tensor:
    f32_ = dict(device=device, dtype=torch.float32)
    ys, xs = torch.meshgrid(torch.arange(h, **f32_), torch.arange(w, **f32_),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(n, h, w, 2)


def level_targets(levels: Sequence[int]) -> List[List[int]]:
    """Targets per pyramid level: those whose depth reaches it."""
    return [[i for i, d in enumerate(levels) if d > lvl]
            for lvl in range(max(levels))]


def upsample(params: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's convex upsampling x8 of (N, h, w, P, 2) control points with
    (N, 576, h, w) logits: each fine pixel is a softmax-weighted mix of the
    3x3 coarse neighbours of its cell."""
    n, h, w, p, _ = params.shape
    flow = params.reshape(n, h, w, 2 * p).permute(0, 3, 1, 2)
    m = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(n, 2 * p, 9, 1, 1,
                                                          h, w)
    up = (m * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, p, 2, 8 * h, 8 * w).permute(0, 3, 4, 1, 2)


class Reference:
    """RAFT-Spline over the state dict ``params`` of the configuration's
    ``model`` section. ``train`` normalizes BatchNorm by the batch (its
    running statistics are not moved: nothing compared reads them).
    ``lookup_hook(level, vol, coords)``, when given, sees every window
    lookup: the level, its (Tl, N, h1, w1, hl, wl) volume and its
    (Tl, N, h1, w1, 2) coordinates at the level's scale."""

    def __init__(self, model_cfg: Dict, params: Dict[str, torch.Tensor],
                 rounding: Optional[str] = None,
                 lookup_hook: Optional[Callable] = None):
        c = model_cfg
        if c["ev_radius"] != RADIUS or c["img_radius"] != RADIUS:
            raise ValueError("the reference looks up radius 4 windows")
        if c.get("detach_bezier"):
            raise ValueError("detach_bezier is not modelled")
        self.c = c
        self.p = params
        self.q = make_rounding(rounding)
        self.lookup_hook = lookup_hook
        self.train = False

    # -- layers ------------------------------------------------------------

    def conv(self, name: str, x, stride: int = 1, padding=0):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        return F.conv2d(self.q(x), self.q(w), b.float(), stride, padding)

    def norm(self, kind: str, name: str, x):
        if kind == "instance":
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
            return (x - mean) * torch.rsqrt(var + EPS)
        if kind != "batch":
            raise ValueError(f"norm {kind!r} is not modelled")
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            mean = self.p[name + ".running_mean"]
            var = self.p[name + ".running_var"]
        scale = self.p[name + ".weight"] * torch.rsqrt(var + EPS)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.p[name + ".bias"][None, :, None, None])

    def encoder(self, pre: str, x, kind: str):
        x = F.relu(self.norm(kind, pre + ".norm1",
                             self.conv(pre + ".conv1", x, 2, 3)))
        for stage, stride in ((1, 1), (2, 2), (3, 2)):
            for blk in (0, 1):
                b = f"{pre}.layer{stage}.{blk}"
                s = stride if blk == 0 else 1
                y = F.relu(self.norm(kind, b + ".norm1",
                                     self.conv(b + ".conv1", x, s, 1)))
                y = F.relu(self.norm(kind, b + ".norm2",
                                     self.conv(b + ".conv2", y, 1, 1)))
                if s != 1:
                    x = self.norm(kind, b + ".downsample.1",
                                  self.conv(b + ".downsample.0", x, s))
                x = F.relu(x + y)
        return self.conv(pre + ".conv2", x)

    def correlation(self, ref, tgt):
        """(T, N, D, h, w) x (T, N, D, hk, wk) -> (T, N, h, w, hk, wk)."""
        t, n, d, h, w = ref.shape
        hk, wk = tgt.shape[-2:]
        a = self.q(ref.reshape(t, n, d, h * w).transpose(-1, -2))
        b = self.q(tgt.reshape(t, n, d, hk * wk))
        return (torch.matmul(a, b) / math.sqrt(d)).reshape(t, n, h, w, hk, wk)

    def lookup(self, vol, coords):
        """(Tl, N, h1, w1, hl, wl) volume, (Tl, N, h1, w1, 2) coords at its
        scale -> (N, h1, w1, Tl * 81): bilinear windows, dy-major."""
        tl, n, h1, w1, hl, wl = vol.shape
        if hl < 2 or wl < 2:  # a zero row or column, which lies outside
            vol = F.pad(vol, (0, max(0, 2 - wl), 0, max(0, 2 - hl)))
            hl, wl = vol.shape[-2:]
        d = torch.arange(-RADIUS, RADIUS + 1, device=vol.device,
                         dtype=torch.float32)
        dy, dx = torch.meshgrid(d, d, indexing="ij")
        pts = coords.reshape(-1, 1, 2) + torch.stack(
            [dx.reshape(-1), dy.reshape(-1)], dim=-1)
        grid = torch.stack([2.0 * pts[..., 0] / (wl - 1) - 1.0,
                            2.0 * pts[..., 1] / (hl - 1) - 1.0], dim=-1)
        rows, grid = vol.reshape(-1, 1, hl, wl), grid[:, :, None]
        blocks = -(-rows.numel() // SAMPLE_ELEMS)
        out = torch.cat([F.grid_sample(v, g, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=True)
                         for v, g in zip(rows.chunk(blocks),
                                         grid.chunk(blocks))])
        win = (2 * RADIUS + 1) ** 2
        return out.reshape(tl, n, h1, w1, win).permute(1, 2, 3, 0, 4).reshape(
            n, h1, w1, tl * win)

    def update(self, net, inp, corr, bez):
        """One refinement step: (net, mask logits, Bezier delta)."""
        u = "update_block"
        n, h1, w1, c = corr.shape
        w = self.p[u + ".encoder.convc1.weight"].reshape(256, c)
        x = F.linear(self.q(corr.reshape(-1, c)), self.q(w),
                     self.p[u + ".encoder.convc1.bias"])
        cor = F.relu(x).reshape(n, h1, w1, 256).permute(0, 3, 1, 2)
        cor = F.relu(self.conv(u + ".encoder.convc2", cor, 1, 1))
        flo = F.relu(self.conv(u + ".encoder.convf1", bez, 1, 3))
        flo = F.relu(self.conv(u + ".encoder.convf2", flo, 1, 1))
        out = F.relu(self.conv(u + ".encoder.conv",
                               torch.cat([cor, flo], dim=1), 1, 1))
        x = torch.cat([inp, out, bez], dim=1)
        h = net
        for sfx, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(self.conv(f"{u}.gru.convz{sfx}", hx, 1, pad))
            r = torch.sigmoid(self.conv(f"{u}.gru.convr{sfx}", hx, 1, pad))
            qq = torch.tanh(self.conv(f"{u}.gru.convq{sfx}",
                                      torch.cat([r * h, x], dim=1), 1, pad))
            h = (1.0 - z) * h + z * qq
        delta = self.conv(u + ".bezier_head.conv2", F.relu(
            self.conv(u + ".bezier_head.conv1", h, 1, 1)), 1, 1)
        mask = self.conv(u + ".mask.2", F.relu(
            self.conv(u + ".mask.0", h, 1, 1)))
        return h, 0.25 * mask, delta

    # -- the network -------------------------------------------------------

    def forward(self, voxel, images, iters: int, train: bool = False):
        """Every iteration's upsampled control points when ``train``, else
        (final low-res, final upsampled) control points."""
        with f32():
            self.train = train
            return self._forward(voxel, images, iters, train)

    def _forward(self, voxel, images, iters, train):
        c = self.c
        ncorr, nctx = c["nbins_correlation"], c["nbins_context"]
        targets = list(c["ev_target_indices"]) if c["use_events"] else []
        depths = (list(c["ev_levels"]) if c["use_events"] else []) + (
            [c["img_levels"]] if c["use_images"] else [])
        times = [t / (nctx - 1) for t in targets] + (
            [1.0] if c["use_images"] else [])
        refs, tgts, ctx = [], [], []
        if c["use_events"]:
            v = voxel.float().permute(0, 3, 1, 2)
            n = v.shape[0]
            grids = [v[:, i:i + ncorr] for i in [0] + targets]
            f = self.encoder("fnet_ev", torch.cat(grids), c["feature_norm"])
            f = list(torch.split(f, n))
            refs += [f[0]] * len(targets)
            tgts += f[1:]
            ctx.append(v[:, -nctx:])
        if c["use_images"]:
            im = (2.0 * images.float() / 255.0 - 1.0).permute(0, 1, 4, 2, 3)
            n = im.shape[1]
            f0, f1 = torch.split(self.encoder(
                "fnet_img", torch.cat([im[0], im[1]]), c["feature_norm"]), n)
            refs.append(f0)
            tgts.append(f1)
            ctx.append(im[0])
        cn = self.encoder("cnet", torch.cat(ctx, dim=1), c["context_norm"])
        hd = c["hidden_dim"]
        net, inp = torch.tanh(cn[:, :hd]), F.relu(cn[:, hd:])

        ref, tgt = torch.stack(refs), torch.stack(tgts)
        pyramid = []
        for lvl, idx in enumerate(level_targets(depths)):
            if lvl:  # 2x2 mean of the targets' features, odd edges dropped
                tgt = tgt[[prev.index(i) for i in idx]]
                t, nb, d, hk, wk = tgt.shape
                tgt = F.avg_pool2d(tgt.reshape(t * nb, d, hk, wk), 2)
                tgt = tgt.reshape(t, nb, d, *tgt.shape[-2:])
            pyramid.append((idx, self.correlation(ref[idx], tgt)))
            prev = idx

        n, _, h1, w1 = net.shape
        coords0 = coords_grid(n, h1, w1, net.device)
        deg = c["bezier_degree"]
        params = torch.zeros(n, h1, w1, deg, 2, device=net.device)
        preds = []
        for it in range(iters):
            coords = coords0[None] + flow_at(params, times)
            feats = []
            for lvl, (idx, vol) in enumerate(pyramid):
                cl = coords[idx] / (2.0 ** lvl)
                if self.lookup_hook is not None:
                    self.lookup_hook(lvl, vol, cl)
                feats.append(self.lookup(vol, cl))
            bez = params.transpose(3, 4).reshape(n, h1, w1, 2 * deg).permute(
                0, 3, 1, 2)
            net, mask, delta = self.update(net, inp, torch.cat(feats, dim=3),
                                           bez)
            params = params + delta.permute(0, 2, 3, 1).reshape(
                n, h1, w1, 2, deg).transpose(3, 4)
            if train or it == iters - 1:
                preds.append(upsample(params, mask))
        if train:
            return preds
        return params, preds[-1]
