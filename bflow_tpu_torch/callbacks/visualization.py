"""Rendering utilities for training/validation media logging (the port's
counterpart of bflow_tpu/callbacks/visualization.py).

Flow -> RGB (Middlebury wheel), error heatmaps (clipped coolwarm),
red/blue percentile rendering of event representations and the
horizontal summary strips are numpy and bit-equal to the JAX package's:
the coolwarm lookup table is matplotlib's, stored here as bytes (a CPU
test holds it to matplotlib's colormap), so no plotting library is
needed. The Bezier trajectory grid and the gradient-magnitude bar chart,
matplotlib figures in the JAX package, are drawn with cv2 into RGB uint8
arrays: the same content (``n_points``^2 sampled trajectories over
``bezier_coefficients``, one bar per parameter), not the same pixels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bflow_tpu_torch.callbacks.flow_vis import flow_to_color
from bflow_tpu_torch.ops.bezier import bezier_coefficients

# per-dataset error-map clipping
ERROR_CLIP = {"dsec": 3.0, "multiflow2d": 2.0}

# matplotlib's coolwarm (256 entries), each RGB channel as uint8(255 * v)
_COOLWARM = np.frombuffer(bytes.fromhex(
    "3a4cc03b4dc13c4fc33e51c43f53c64054c74156c94258ca435acc455bcd465dcf475fd0"
    "4860d14962d34b64d44c66d64d67d74e69d8506bda516cdb526edc5370dd5571de5673e0"
    "5775e15876e25a78e35b79e45c7be55d7de65f7ee76080e86182ea6383ea6485eb6586ec"
    "6788ed6889ee698bef6b8df06c8ef16d90f16f91f27093f37194f47395f47497f57598f6"
    "779af6789bf77a9df87b9ef87ca0f97ea1f97fa2fa80a4fa82a5fb83a6fb85a8fb86a9fc"
    "87aafc89acfc8aadfd8baefd8daffd8eb1fd90b2fe91b3fe92b4fe94b5fe95b7fe97b8fe"
    "98b9fe99bafe9bbbfe9cbcfe9dbdfe9fbefea0bffea2c0fea3c1fea4c2fea6c3fda7c4fd"
    "a8c5fdaac6fdabc7fcacc8fcaec9fcafcafbb0cbfbb2cbfbb3ccfab4cdfab6cef9b7cff9"
    "b8cff8b9d0f8bbd1f7bcd1f6bdd2f6bed3f5c0d3f5c1d4f4c2d4f3c3d5f2c5d5f2c6d6f1"
    "c7d6f0c8d7efc9d7eecad8eeccd8edcdd9ecced9ebcfd9ead0dae9d1dae8d2dae7d3dbe6"
    "d5dbe5d6dbe4d7dbe2d8dbe1d9dce0dadcdfdbdcdedcdcdddddcdbdedbdadfdbd9e0dad7"
    "e1dad6e2d9d4e3d9d3e4d8d1e5d8d0e6d7cfe7d6cde7d6cce8d5cae9d4c9ead3c7ebd3c6"
    "ecd2c4ecd1c3edd0c1edcfc0eecfbeefcebcefcdbbf0ccb9f1cbb8f1cab6f2c9b5f2c8b3"
    "f2c7b2f3c6b0f3c5aff4c4adf4c3abf4c2aaf5c1a8f5c0a7f5bfa5f6bda4f6bca2f6bba0"
    "f6ba9ff6b99df6b79cf6b69af7b598f7b397f7b295f7b194f7b092f7ae91f7ad8ff6ab8d"
    "f6aa8cf6a98af6a789f6a687f6a486f6a384f5a182f5a081f59e7ff49d7ef49b7cf49a7b"
    "f39879f39678f39576f29375f29173f19072f18e70f08d6ff08b6def896cee876aee8669"
    "ed8467ec8266ec8064eb7f63ea7d61ea7b60e9795ee8775de7755ce6745ae67259e57057"
    "e46e56e36c54e26a53e16852e06650df644fde624edd604cdc5e4bdb5c4ada5a48d95847"
    "d85646d75444d65243d44f42d34d40d24b3fd1493ecf463dce443ccd423acc3f39ca3d38"
    "c93b37c83835c63534c53233c43032c22d31c12a30bf282ebe232dbc1f2cbb1a2bb9162a"
    "b81129b60d28b50827b30326"), np.uint8).reshape(256, 3)


def coolwarm_u8(values: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 of matplotlib's ``(cm.coolwarm(v)[..., :3] * 255)
    .astype(uint8)`` for v in [0, 1]: entry floor(v * 256), 1 -> the last;
    NaN -> 0 (the colormap's transparent 'bad' color)."""
    x = np.asarray(values) * 256
    bad = np.isnan(x)
    idx = np.clip(np.where(bad, 0, x), 0, 255).astype(int)
    out = _COOLWARM[idx]
    out[bad] = 0
    return out


def render_event_representation(
    ev_repr: np.ndarray, lo_pct: float = 2.0, hi_pct: float = 98.0
) -> np.ndarray:
    """(H, W) summed event grid -> (H, W, 3) red/blue uint8 rendering.

    Positive mass is red, negative blue, scaled by robust percentiles.
    """
    assert ev_repr.ndim == 2
    img = np.full(ev_repr.shape + (3,), 255, np.uint8)
    pos = ev_repr[ev_repr > 0]
    neg = ev_repr[ev_repr < 0]
    hi = np.percentile(pos, hi_pct) if pos.size else 1.0
    lo = np.percentile(-neg, hi_pct) if neg.size else 1.0
    scale_pos = np.clip(ev_repr / max(hi, 1e-6), 0, 1)
    scale_neg = np.clip(-ev_repr / max(lo, 1e-6), 0, 1)
    img[..., 1] = 255 * (1 - np.maximum(scale_pos, scale_neg))
    img[..., 2] = 255 * (1 - scale_pos)
    img[..., 0] = 255 * (1 - scale_neg)
    return img


def render_error_map(
    pred: np.ndarray,
    gt: np.ndarray,
    valid: Optional[np.ndarray] = None,
    clip: float = 3.0,
) -> np.ndarray:
    """End-point-error heatmap, coolwarm, clipped. (H, W, 3) uint8."""
    epe = np.sqrt(((pred - gt) ** 2).sum(-1))
    if valid is not None:
        epe = epe * valid
    return coolwarm_u8(np.clip(epe / clip, 0, 1))


def summary_image(
    pred_flow: np.ndarray,
    gt_flow: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    ev_repr_sum: Optional[np.ndarray] = None,
    image: Optional[np.ndarray] = None,
    error_clip: float = 3.0,
) -> np.ndarray:
    """Horizontal strip: [events | image | pred | gt | error]."""
    rad_max = None
    if gt_flow is not None:
        rad_max = max(np.sqrt((gt_flow**2).sum(-1)).max(), 1e-6)
    panels: List[np.ndarray] = []
    if ev_repr_sum is not None:
        panels.append(render_event_representation(ev_repr_sum))
    if image is not None:
        panels.append(image.astype(np.uint8))
    panels.append(flow_to_color(pred_flow, rad_max=rad_max))
    if gt_flow is not None:
        panels.append(flow_to_color(gt_flow, rad_max=rad_max))
        panels.append(
            render_error_map(pred_flow, gt_flow, valid, clip=error_clip)
        )
    return np.concatenate(panels, axis=1)


_GREY, _BLACK = (200, 200, 200), (0, 0, 0)
_BLUE, _RED = (31, 119, 180), (214, 39, 40)  # RGB
_PANEL = 120  # px per trajectory panel
_CHART_H, _BAR = 240, 4  # gradient chart height, px per bar


def bezier_trajectory_image(
    bezier_params: np.ndarray,
    n_points: int = 5,
    n_times: int = 20,
) -> np.ndarray:
    """(rows, cols, 3) RGB uint8 grid of sampled per-pixel Bezier
    trajectories: ``n_points``^2 pixels on a regular grid, each panel its
    displacement curve over ``n_times`` times in [0, 1] (image
    coordinates: y grows downward), the origin as a red dot, the pixel as
    the title.

    bezier_params: (H, W, degree, 2)."""
    import cv2

    H, W, degree, _ = bezier_params.shape
    coeffs = bezier_coefficients(degree, np.linspace(0, 1, n_times))
    panel = _PANEL
    img = np.full((n_points * panel, n_points * panel, 3), 255, np.uint8)
    ys = np.linspace(0, H - 1, n_points).astype(int)
    xs = np.linspace(0, W - 1, n_points).astype(int)
    top, pad = 16, 8  # title band, margin
    for ai, y in enumerate(ys):
        for aj, x in enumerate(xs):
            traj = coeffs @ np.asarray(bezier_params[y, x], np.float64)
            pts = np.concatenate([traj, np.zeros((1, 2))])  # with origin
            lo, hi = pts.min(0), pts.max(0)
            span = np.maximum(hi - lo, 1e-6)
            x0, y0 = aj * panel + pad, ai * panel + top
            size = np.array([panel - 2 * pad, panel - top - pad])
            px = np.round((pts - lo) / span * (size - 1)
                          + (x0, y0)).astype(np.int32)
            cv2.rectangle(img, (x0, y0), (x0 + size[0] - 1, y0 + size[1] - 1),
                          _GREY, 1)
            cv2.polylines(img, [px[:-1].reshape(-1, 1, 2)], False, _BLUE, 1,
                          cv2.LINE_AA)
            for p in px[:-1]:
                cv2.circle(img, (int(p[0]), int(p[1])), 2, _BLUE, -1)
            cv2.circle(img, (int(px[-1, 0]), int(px[-1, 1])), 3, _RED, -1)
            cv2.putText(img, f"({x},{y})", (x0, y0 - 4),
                        cv2.FONT_HERSHEY_PLAIN, 0.8, _BLACK, 1, cv2.LINE_AA)
    return img


def grad_flow_image(named_grad_norms: Sequence) -> np.ndarray:
    """(240, width, 3) RGB uint8 bar chart of per-parameter gradient
    magnitudes, one bar per (name, value) in the given order, scaled to
    the largest, which is printed with the count."""
    import cv2

    height, bar = _CHART_H, _BAR
    vals = np.array([float(v) for _, v in named_grad_norms], np.float64)
    top, pad = 20, 8
    width = max(320, 2 * pad + bar * len(vals))
    img = np.full((height, width, 3), 255, np.uint8)
    base = height - pad
    vmax = vals.max() if vals.size and vals.max() > 0 else 1.0
    for i, v in enumerate(vals):
        h = int(round(v / vmax * (base - top)))
        x = pad + i * bar
        cv2.rectangle(img, (x, base - h), (x + bar - 2, base), _BLUE, -1)
    cv2.line(img, (pad, base), (width - pad, base), _BLACK, 1)
    cv2.putText(img, f"mean |grad| of {len(vals)} parameters, max {vmax:.3g}",
                (pad, top - 6), cv2.FONT_HERSHEY_PLAIN, 0.9, _BLACK, 1,
                cv2.LINE_AA)
    return img
