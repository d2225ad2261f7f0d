"""Multi-target correlation volumes with per-target pyramid depths.

Counterpart of bflow_tpu/models/corr.py, without its TPU-only layouts
(row padding to 16, row slabs, lane bands): a level's volume is laid out
(Tl, N, h1, w1, hl, wl), which flattens to the (Q, hl, wl) per-query maps
that the lookup kernel reads, with no copy.

The windowed lookup keeps the reference channel contract: channels are
ordered level-major, then target (ascending base index), then the
(2r+1)^2 window flattened dy-major, the order the released checkpoints'
1x1 motion-encoder conv expects.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

from bflow_tpu_torch.kernels.corr_lookup import (
    corr_lookup_level,
    corr_lookup_level_plain,
)

# One pyramid level: (base-target indices at this level, volume).
CorrLevel = Tuple[Tuple[int, ...], torch.Tensor]

# lookup_method -> per-level lookup. 'auto' and 'pallas' name the lookup
# kernel (the JAX package's Pallas kernel on the TPU), 'gather' its plain
# version, the JAX package's oracle.
LOOKUPS = {
    "auto": corr_lookup_level,
    "pallas": corr_lookup_level,
    "gather": corr_lookup_level_plain,
}


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
    pyramid: List[CorrLevel] = [
        (per_level[0], all_pairs_correlation(fmap_ref, fmap_tgt, precision))
    ]
    prev_idx, prev_tgt = per_level[0], fmap_tgt
    for idx_tuple in per_level[1:]:
        sel = [prev_idx.index(i) for i in idx_tuple]
        tgt = _avg_pool_2x2(prev_tgt[sel])
        ref = fmap_ref[list(idx_tuple)]
        pyramid.append(
            (idx_tuple, all_pairs_correlation(ref, tgt, precision)))
        prev_idx, prev_tgt = idx_tuple, tgt
    return pyramid


def corr_lookup(
    pyramid: List[CorrLevel],
    coords: torch.Tensor,
    radius: int,
    method: str = "auto",
    concat: bool = True,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Gather (2r+1)^2 bilinear windows around per-target query coords.

    Args:
      pyramid: output of build_corr_pyramid.
      coords: (T, N, h1, w1, 2) f32 query positions per base target, in
        full-resolution volume pixels, (x, y) last; level l divides by 2^l.
      radius: window radius r.
      method: 'auto' | 'pallas' (the lookup kernel; its plain version for
        CPU tensors) | 'gather' (the plain version everywhere).
      concat: True -> one (N, h1, w1, C) map, channels (level, target,
        window). False -> the per-level (Tl, N, h1, w1, (2r+1)^2) list.
    """
    if method not in LOOKUPS:
        raise NotImplementedError(
            f"lookup_method={method!r} is not ported yet (ROADMAP Queue 1 "
            f"item 10; 'pallas_q8' also needs Queue 2 item 3)")
    lookup = LOOKUPS[method]
    T, N, h1, w1, _ = coords.shape
    outs: List[torch.Tensor] = []
    for lvl, (target_idx, vol) in enumerate(pyramid):
        c = coords[list(target_idx)] / (2.0 ** lvl)
        q = len(target_idx) * N * h1 * w1
        hl, wl = vol.shape[-2:]
        feat = lookup(vol.reshape(q, hl, wl), c.reshape(q, 2), radius)
        outs.append(feat.reshape(len(target_idx), N, h1, w1, -1))
    if not concat:
        return outs
    return torch.cat(
        [f.permute(1, 2, 3, 0, 4).reshape(N, h1, w1, -1) for f in outs],
        dim=-1)
