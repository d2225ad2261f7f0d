"""Bezier curve parameterization of continuous-time optical flow.

Per pixel, the model regresses the control points P1..Pn of a degree-n
Bezier curve (P0 == 0, the pixel itself); the flow at a time t in [0, 1]
is the curve evaluated at t. Evaluation times are Python floats, so the
Bernstein coefficients are computed on the host in float64, cast there to
the curve's type, and kept on its device in a small LRU cache keyed by
(degree, time, type, device): the lookup and supervision times are
static, so after the first step no call copies to the device, and a miss
on CUDA copies from pinned memory without waiting for the stream.

Layout as in the JAX package: params (N, H, W, degree, 2), last axis
(x, y).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch

from bflow_tpu_torch.ops.upsample import convex_upsample
from bflow_tpu_torch.utils.precision import full_f32

TimeLike = Union[float, int, Sequence[float]]

COEFF_CACHE_SIZE = 256  # coefficient vectors kept on the devices

# what flow_at's coefficient cache did since the last reset_counters()
coeff_hits = 0
coeff_misses = 0

_coeffs: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_coeffs_lock = threading.Lock()


def reset_counters() -> None:
    global coeff_hits, coeff_misses
    coeff_hits = coeff_misses = 0


def bezier_coefficients(degree: int, timestamps: Sequence[float]) -> np.ndarray:
    """Bernstein coefficients for control points P1..Pn at given times.

    Returns (T, degree) float64: coeff[t, i-1] = C(n, i) (1-t)^(n-i) t^i.
    P0's term is omitted because P0 == 0 by construction.
    """
    assert degree >= 1
    ts = np.asarray(timestamps, dtype=np.float64)
    assert ts.ndim == 1 and ts.size > 0
    assert ts.min() >= 0.0 and ts.max() <= 1.0
    out = np.empty((ts.size, degree), dtype=np.float64)
    for j in range(degree):
        i = j + 1
        out[:, j] = math.comb(degree, i) * (1.0 - ts) ** (degree - i) * ts**i
    return out


def _coefficients(degree: int, t: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(degree,) Bernstein coefficients at time t on the device, from the
    LRU cache; a miss casts the float64 row on the host and copies it
    (from pinned memory without a wait on CUDA)."""
    global coeff_hits, coeff_misses
    key = (degree, t, dtype, device)
    with _coeffs_lock:
        coeff = _coeffs.get(key)
        if coeff is not None:
            coeff_hits += 1
            _coeffs.move_to_end(key)
            return coeff
        coeff_misses += 1
        # a tensor made under inference_mode could not be saved for a
        # later backward
        with torch.inference_mode(False):
            host = torch.as_tensor(bezier_coefficients(degree, (t,))[0],
                                   dtype=dtype)
            if device.type == "cuda":
                coeff = host.pin_memory().to(device, non_blocking=True)
            else:
                coeff = host.to(device)
        _coeffs[key] = coeff
        if len(_coeffs) > COEFF_CACHE_SIZE:
            _coeffs.popitem(last=False)
        return coeff


@dataclass(frozen=True)
class BezierCurves:
    """Per-pixel Bezier flow curves; params (N, H, W, degree, 2)."""

    params: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, ht: int, wd: int, degree: int,
              device=None, dtype=torch.float32) -> "BezierCurves":
        assert degree >= 1
        return cls(torch.zeros((batch, ht, wd, degree, 2),
                               device=device, dtype=dtype))

    @classmethod
    def from_flow(cls, flow: torch.Tensor) -> "BezierCurves":
        """Degree-1 (linear) curve from a two-view flow field (N, H, W, 2)."""
        if flow.shape[-1] != 2:
            raise ValueError(f"flow {tuple(flow.shape)}: last axis must be 2")
        return cls(flow[..., None, :])

    @property
    def batch(self) -> int:
        return self.params.shape[0]

    @property
    def height(self) -> int:
        return self.params.shape[1]

    @property
    def width(self) -> int:
        return self.params.shape[2]

    @property
    def degree(self) -> int:
        return self.params.shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.params.dtype

    def astype(self, dtype: torch.dtype) -> "BezierCurves":
        return BezierCurves(self.params.to(dtype))

    def delta_update(self, delta: torch.Tensor) -> "BezierCurves":
        if delta.shape != self.params.shape:
            raise ValueError(f"delta {tuple(delta.shape)} does not match "
                             f"params {tuple(self.params.shape)}")
        return BezierCurves(self.params + delta)

    def flow_at(self, times: TimeLike) -> torch.Tensor:
        """Flow from the reference frame at time(s) in [0, 1].

        Scalar time -> (N, H, W, 2); sequence of T times -> (T, N, H, W, 2).
        The contraction over the control points runs in full f32
        (utils/precision.py), as the JAX package's runs at HIGHEST. The
        coefficients come from the device cache (module docstring), so a
        call does not wait for the device.
        """
        scalar = isinstance(times, (int, float))
        ts = (float(times),) if scalar else tuple(float(t) for t in times)
        flows = []
        for t in ts:
            if t == 0.0:
                flows.append(torch.zeros_like(self.params[..., 0, :]))
            elif t == 1.0:
                # all Bernstein terms vanish except the last control point
                flows.append(self.params[..., -1, :])
            else:
                coeff = _coefficients(self.degree, t, self.params.dtype,
                                      self.params.device)
                with full_f32():
                    flows.append(torch.einsum("nhwpd,p->nhwd",
                                              self.params, coeff))
        if scalar:
            return flows[0]
        return torch.stack(flows, dim=0)

    def upsampled(self, mask: torch.Tensor, factor: int = 8) -> "BezierCurves":
        """Convex upsampling of all control points jointly; mask is
        (N, H, W, 9 * factor**2)."""
        N, H, W, P, _ = self.params.shape
        flat = self.params.reshape(N, H, W, P * 2)
        up = convex_upsample(flat, mask, factor=factor)
        return BezierCurves(up.reshape(N, H * factor, W * factor, P, 2))
