"""Optical-flow color coding (Baker et al. "A Database and Evaluation
Methodology for Optical Flow", ICCV 2007 — the standard Middlebury wheel).

Vectorized NumPy implementation of the classic color wheel transform used
by every flow toolchain; a copy of bflow_tpu/callbacks/flow_vis.py,
bit-equal to it.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB color wheel: RY15 YG6 GC4 CB11 BM13 MR6 segments."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False),  # R->Y: G ramps up
        (YG, 1, 0, True),  # Y->G: R ramps down
        (GC, 1, 2, False),  # G->C: B ramps up
        (CB, 2, 1, True),  # C->B: G ramps down
        (BM, 2, 0, False),  # B->M: R ramps up
        (MR, 0, 2, True),  # M->R: B ramps down
    ]
    for length, base, ramp, down in ramps:
        wheel[col : col + length, base] = 255
        r = np.floor(255 * np.arange(length) / length)
        wheel[col : col + length, ramp] = 255 - r if down else r
        col += length
    return wheel


_WHEEL = make_colorwheel()


def flow_to_color(
    flow: np.ndarray, clip_flow: float = None, rad_max: float = None
) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury-coded RGB."""
    assert flow.ndim == 3 and flow.shape[-1] == 2
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u * u + v * v)
    if rad_max is None:
        rad_max = max(rad.max(), 1e-6)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        # saturate towards white inside the unit circle
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col)
    return img
