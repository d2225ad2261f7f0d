"""Multi-target correlation volumes with per-target pyramid depths.

Counterpart of bflow_tpu/models/corr.py, without its TPU-only layouts
(row padding to 16, row slabs, lane bands): a level's volume is laid out
(Tl, N, h1, w1, hl, wl), which flattens to the (Q, hl, wl) per-query maps
that the lookup kernel reads, with no copy.

The windowed lookup keeps the reference channel contract: channels are
ordered level-major, then target (ascending base index), then the
(2r+1)^2 window flattened dy-major, the order the released checkpoints'
1x1 motion-encoder conv expects.

Lookup methods ('auto' and 'pallas' are the lookup kernel, which is what
'auto' resolves to on the JAX package's accelerator):
  auto, pallas  the CUDA lookup kernel, every level in one launch per call
                (its plain version on the CPU); under autograd the levels'
                dVol accumulates in one buffer per level for all of a
                pyramid's lookups (kernels.corr_lookup.VolumeSink)
  pallas_q8     the same kernel and launch, with the levels whose row
                count, padded to 16 as in the JAX package, is >= 32 held
                as int8 volumes with per-row scales in its level table
                (their taps bf16; inference only)
  gather        the plain lookup everywhere (the JAX package's oracle)
  onehot        the JAX package's one-hot matmul formulation, f32 output
With onehot_from_level >= 0, the kernel methods send the levels from that
index on to the one-hot lookup (output cast to the volume's type).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

from bflow_tpu_torch.kernels.corr_lookup import (
    TableLevel,
    VolumeSink,
    corr_lookup_level_plain,
    corr_lookup_pyramid,
    quantize_volume,
)

# One pyramid level: (base-target indices at this level, volume), the
# volume an (int8 volume, scale) pair on the levels pallas_q8 quantizes.
CorrLevel = Tuple[Tuple[int, ...],
                  Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


class CorrPyramid(list):
    """The list of CorrLevel that the pyramid builders return, carrying
    the VolumeSink that every lookup of it shares under autograd.
    corr_lookup takes a plain list too, but not on the kernel path with
    volumes that need gradients: that path needs the sink."""

    def __init__(self, levels=()):
        super().__init__(levels)
        self.sink = VolumeSink()


KERNEL_METHODS = ("auto", "pallas", "pallas_q8")
METHODS = (*KERNEL_METHODS, "gather", "onehot")


def all_pairs_correlation(fmap_ref: torch.Tensor, fmap_tgt: torch.Tensor,
                          precision: str = "float32") -> torch.Tensor:
    """(T, N, h, w, D) x (T, N, hk, wk, D) -> (T, N, h, w, hk, wk) / sqrt(D).

    bf16: the scaled reference features are rounded to bf16 after an f32
    division, the product accumulates in f32 and the volume is bf16."""
    T, N, h, w, D = fmap_ref.shape
    Tk, Nk, hk, wk, Dk = fmap_tgt.shape
    assert (Tk, Nk, Dk) == (T, N, D), (fmap_ref.shape, fmap_tgt.shape)
    a = fmap_ref.reshape(T, N, h * w, D)
    b = fmap_tgt.reshape(T, N, hk * wk, D)
    scale = math.sqrt(D)
    if precision == "bfloat16":
        a = (a.float() / scale).to(torch.bfloat16)
        vol = torch.matmul(a, b.to(torch.bfloat16).transpose(-1, -2))
    elif precision == "float32":
        vol = torch.matmul(a.float(), b.float().transpose(-1, -2)) / scale
    else:
        raise ValueError(precision)
    return vol.reshape(T, N, h, w, hk, wk)


def _avg_pool_2x2(fmap: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 mean over the (h, w) axes of (T, N, h, w, D) features,
    truncating odd trailing rows/cols (avg_pool2d semantics; a 1-row map
    pools to an empty one, as in the JAX package)."""
    T, N, h, w, D = fmap.shape
    h2, w2 = h // 2, w // 2
    v = fmap[:, :, :2 * h2, :2 * w2].reshape(T, N, h2, 2, w2, 2, D)
    return v.mean(dim=(3, 5))


def level_target_indices(
    levels_per_target: Sequence[int],
) -> List[Tuple[int, ...]]:
    """Target-index tuples per pyramid level.

    levels [1,1,1,4,4] -> [(0,1,2,3,4), (3,4), (3,4), (3,4)].
    """
    max_lvl = max(levels_per_target)
    return [
        tuple(i for i, v in enumerate(levels_per_target) if v >= lvl)
        for lvl in range(1, max_lvl + 1)
    ]


def _take_targets(x: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """x[list(idx)] along axis 0 without an index tensor, which CUDA
    would copy from the host and wait for: a slice for a contiguous run
    of indices, else a stack of integer-indexed views laid out in x's
    memory order, so the result has the strides indexing gives."""
    idx = tuple(idx)
    start = idx[0]
    if idx == tuple(range(start, start + len(idx))):
        return x[start:start + len(idx)]
    perm = sorted(range(x.dim()), key=lambda d: (d != 0, -x.stride(d)))
    xp = x.permute(perm)
    inverse = sorted(range(x.dim()), key=perm.__getitem__)
    return torch.stack([xp[i] for i in idx]).permute(inverse)


def build_corr_pyramid(fmap_ref: torch.Tensor, fmap_tgt: torch.Tensor,
                       levels_per_target: Sequence[int],
                       precision: str = "float32") -> List[CorrLevel]:
    """Per-level all-pairs volumes against pooled target features.

    Average pooling over the target-map axes commutes with the dot product
    over features, so pooling the target features (2x2, odd trailing
    rows/cols truncated as avg_pool2d does) and correlating again gives the
    reference's pooled-volume pyramid. Inputs are (T, N, h, w, D)."""
    T = fmap_ref.shape[0]
    assert len(levels_per_target) == T, (levels_per_target, T)
    per_level = level_target_indices(levels_per_target)
    pyramid = CorrPyramid([
        (per_level[0], all_pairs_correlation(fmap_ref, fmap_tgt, precision))
    ])
    prev_idx, prev_tgt = per_level[0], fmap_tgt
    for idx_tuple in per_level[1:]:
        sel = [prev_idx.index(i) for i in idx_tuple]
        tgt = _avg_pool_2x2(_take_targets(prev_tgt, sel))
        ref = _take_targets(fmap_ref, idx_tuple)
        pyramid.append(
            (idx_tuple, all_pairs_correlation(ref, tgt, precision)))
        prev_idx, prev_tgt = idx_tuple, tgt
    return pyramid


def quantizes(hl: int) -> bool:
    """The JAX package's pallas_q8 gate (models/corr.py:218): it pads a
    level's rows to a multiple of 16 and quantizes when that is >= 32."""
    return -(-hl // 16) * 16 >= 32


def build_pyramid_for_method(fmap_ref: torch.Tensor, fmap_tgt: torch.Tensor,
                             levels_per_target: Sequence[int],
                             precision: str, method: str,
                             onehot_from_level: int = -1) -> List[CorrLevel]:
    """build_corr_pyramid, with the levels that pallas_q8 quantizes held as
    (int8 volume, (Tl, N, h1) scale): the JAX package's
    build_pyramid_for_method without its slab layout. Levels sent to the
    one-hot lookup (onehot_from_level) stay unquantized."""
    pyramid = build_corr_pyramid(fmap_ref, fmap_tgt, levels_per_target,
                                 precision)
    if method != "pallas_q8":
        return pyramid
    return CorrPyramid((idx, quantize_volume(vol)
                        if quantizes(vol.shape[4])
                        and not 0 <= onehot_from_level <= lvl else vol)
                       for lvl, (idx, vol) in enumerate(pyramid))


def lookup_level_onehot(vol: torch.Tensor, c: torch.Tensor, radius: int,
                        precision: str) -> torch.Tensor:
    """(Tl, N, h1, w1, hl, wl) volume, (Tl, N, h1, w1, 2) coords ->
    (Tl, N, h1, w1, (2r+1)^2) f32: the JAX package's _lookup_level_onehot.
    Each query's (2r+2)^2 integer patch around floor(c) is selected with
    one-hot row and column matrices (all-zero rows outside the map are the
    zero padding) in the ``precision`` type, exactly; the four corner
    windows are blended in f32."""
    Tl, N, h1, w1, hl, wl = vol.shape
    r = radius
    p = 2 * r + 2
    x, y = c[..., 0], c[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    offs = torch.arange(-r, r + 2, device=c.device)
    ry = y0.to(torch.int32)[..., None] + offs  # (Tl, N, h1, w1, p)
    rx = x0.to(torch.int32)[..., None] + offs
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    ey = (ry[..., None] == torch.arange(hl, device=c.device)).to(dtype)
    ex = (rx[..., None] == torch.arange(wl, device=c.device)).to(dtype)
    q = Tl * N * h1 * w1
    # one-hot selections are exact in either type
    t1 = torch.matmul(ey.reshape(q, p, hl), vol.to(dtype).reshape(q, hl, wl))
    patch = torch.matmul(t1, ex.reshape(q, p, wl).transpose(1, 2)).float()
    patch = patch.reshape(Tl, N, h1, w1, p, p)
    win = 2 * r + 1
    out = ((1 - fy) * (1 - fx) * patch[..., :win, :win]
           + (1 - fy) * fx * patch[..., :win, 1:]
           + fy * (1 - fx) * patch[..., 1:, :win]
           + fy * fx * patch[..., 1:, 1:])
    return out.reshape(Tl, N, h1, w1, win * win)


def corr_lookup(
    pyramid: List[CorrLevel],
    coords: torch.Tensor,
    radius: int,
    method: str = "auto",
    concat: bool = True,
    precision: str = "float32",
    onehot_from_level: int = -1,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Gather (2r+1)^2 bilinear windows around per-target query coords.

    Args:
      pyramid: output of build_pyramid_for_method (of build_corr_pyramid
        for every method but pallas_q8).
      coords: (T, N, h1, w1, 2) f32 query positions per base target, in
        full-resolution volume pixels, (x, y) last; level l divides by 2^l.
      radius: window radius r.
      method: one of METHODS (module docstring); the kernels run their
        plain versions for CPU tensors.
      concat: True -> one (N, h1, w1, C) map, channels (level, target,
        window). False -> the per-level (Tl, N, h1, w1, (2r+1)^2) list
        (views of the concatenated map where the lookup kernel wrote it).
      precision: the one-hot matmuls' type ('float32' | 'bfloat16').
      onehot_from_level: with a kernel method, levels >= this index (when
        >= 0) take the one-hot lookup instead.

    With a kernel method, the levels that onehot_from_level does not send
    to the one-hot lookup (a contiguous run of levels, pallas_q8's int8
    levels among them) go through one launch of the lookup kernel, which
    reads the base coords and writes their channels of the concatenated
    map; with no level sent elsewhere, that map is the result. Per level
    (concat=False), an int8 level's lookup is bf16, as in the JAX package.
    """
    if method not in METHODS:
        raise NotImplementedError(
            f"lookup_method={method!r} is not one of the JAX package's "
            f"lookup methods {METHODS}")
    _, N, h1, w1, _ = coords.shape
    win2 = (2 * radius + 1) ** 2
    table: List[TableLevel] = []
    # per level, in level order: a (Tl, N, h1, w1, win2) lookup, or None
    # for the levels of the kernel's table
    outs: List[Union[torch.Tensor, None]] = []
    for lvl, (target_idx, vol) in enumerate(pyramid):
        onehot_here = (method in KERNEL_METHODS
                       and 0 <= onehot_from_level <= lvl)
        if method in KERNEL_METHODS and not onehot_here:
            if isinstance(vol, tuple):  # (int8 volume, per-row scale)
                table.append(TableLevel(vol[0], tuple(target_idx), lvl,
                                        vol[1]))
            else:
                table.append(TableLevel(vol, tuple(target_idx), lvl))
            outs.append(None)
            continue
        if isinstance(vol, tuple):
            raise ValueError(
                f"level {lvl} is an int8 volume (build_pyramid_for_method "
                f"with 'pallas_q8'): method {method!r} and "
                f"onehot_from_level={onehot_from_level} do not look it up")
        c = coords[list(target_idx)] / (2.0 ** lvl)
        q = len(target_idx) * N * h1 * w1
        if method == "onehot" or onehot_here:
            feat = lookup_level_onehot(vol, c, radius, precision)
            if onehot_here:
                feat = feat.to(vol.dtype)
        else:  # gather
            hl, wl = vol.shape[-2:]
            feat = corr_lookup_level_plain(vol.reshape(q, hl, wl),
                                           c.reshape(q, 2), radius)
        outs.append(feat.reshape(len(target_idx), N, h1, w1, win2))
    # per level (Tl, N, h1, w1, win2): the kernel levels as views of its
    # map (N, h1, w1, C), in table order
    kmap = None
    if table:
        sink = pyramid.sink if isinstance(pyramid, CorrPyramid) else None
        kmap = corr_lookup_pyramid(table, coords, radius, sink)
        kviews = kmap.reshape(N, h1, w1, -1, win2).permute(3, 0, 1, 2, 4)
        s = 0
        for lvl, feat in enumerate(outs):
            if feat is None:
                tl = len(pyramid[lvl][0])
                outs[lvl] = kviews[s:s + tl]
                if isinstance(pyramid[lvl][1], tuple):  # exact: bf16 taps
                    outs[lvl] = outs[lvl].to(torch.bfloat16)
                s += tl
    if not concat:
        return outs
    if len(table) == len(outs):
        return kmap
    return torch.cat([f.permute(1, 2, 3, 0, 4) for f in outs],
                     dim=3).reshape(N, h1, w1, -1)
