"""On-device event-to-voxel-grid rasterization (counterpart of
bflow_tpu/ops/voxelize.py).

The training and evaluation pipelines rasterize on the host
(bflow_tpu_torch/data/representations.py) because grids are disk-cached;
this is the *online inference* path: raw event tensors already on the
device are scattered into a voxel grid there, so a streaming deployment
never bounces events through the host.

Semantics match the host rasterizer (bilinear in time for integer
coordinates, trilinear x-y-t for float coordinates, polarity +/-1).
Variable event counts are handled as in the JAX package: the event arrays
are padded to a capacity and padding is marked ``valid=False``, which
zeroes its scatter weights.

Implementation: corner contributions -> flat voxel indices -> one
``index_add_`` into ``n_voxels + 1`` slots, whose last slot swallows the
masked and padding contributions. The JAX package holds no Pallas kernel
here (XLA's segment_sum does the work), and neither does the port: the
scatter is PyTorch's. On CUDA ``index_add_`` adds with float atomics, so
two runs agree to f32 round-off in the order of the additions, not
bitwise.

Time is cast to f32 *before* ``t0_center`` is subtracted, as in the JAX
function: at absolute microsecond timestamps (~1e9 on DSEC) f32 keeps
only ~64 us steps, so callers pass window-relative times.
"""

from __future__ import annotations

import torch


def voxelize_events(
    x: torch.Tensor,
    y: torch.Tensor,
    polarity: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    t0_center,
    t1_center,
    *,
    channels: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Rasterize padded event tensors into an (H, W, C) f32 voxel grid on
    their device.

    Args:
      x, y: (E,) pixel coordinates — float (rectified, trilinear) or
        integer (bilinear in time only).
      polarity: (E,) in {0, 1}.
      t: (E,) integer-like timestamps (microseconds).
      valid: (E,) bool; False entries contribute nothing.
      t0_center, t1_center: scalar window boundaries (centers of the
        first/last temporal bin), numbers or 0-d tensors.
    """
    E = x.shape[0]
    assert y.shape == polarity.shape == t.shape == valid.shape == (E,)
    ch, ht, wd = channels, height, width
    dev = x.device
    f32 = torch.float32

    t0 = torch.as_tensor(t0_center, device=dev).to(f32)
    t1 = torch.as_tensor(t1_center, device=dev).to(f32)
    t_norm = (t.to(f32) - t0) / (t1 - t0) * (ch - 1)
    t_floor = torch.floor(t_norm)
    value = torch.where(valid, 2.0 * polarity.to(f32) - 1.0,
                        torch.zeros((), dtype=f32, device=dev))

    n_voxels = ch * ht * wd
    indices = []
    weights = []
    if not torch.is_floating_point(x):
        xi = x.to(torch.int64)
        yi = y.to(torch.int64)
        for dtc in (0.0, 1.0):
            tlim = t_floor + dtc
            w = value * (1.0 - torch.abs(tlim - t_norm))
            m = (tlim >= 0) & (tlim < ch)
            idx = (yi * wd + xi) * ch + tlim.to(torch.int64)
            indices.append(torch.where(m, idx, n_voxels))
            weights.append(torch.where(m, w, 0.0))
    else:
        xf = x.to(f32)
        yf = y.to(f32)
        x_floor = torch.floor(xf)
        y_floor = torch.floor(yf)
        for dxc in (0.0, 1.0):
            xlim = x_floor + dxc
            wx = 1.0 - torch.abs(xlim - xf)
            for dyc in (0.0, 1.0):
                ylim = y_floor + dyc
                wy = 1.0 - torch.abs(ylim - yf)
                for dtc in (0.0, 1.0):
                    tlim = t_floor + dtc
                    wt = 1.0 - torch.abs(tlim - t_norm)
                    m = ((xlim >= 0) & (xlim < wd)
                         & (ylim >= 0) & (ylim < ht)
                         & (tlim >= 0) & (tlim < ch))
                    idx = ((ylim.to(torch.int64) * wd
                            + xlim.to(torch.int64)) * ch
                           + tlim.to(torch.int64))
                    indices.append(torch.where(m, idx, n_voxels))
                    weights.append(torch.where(m, value * wx * wy * wt, 0.0))

    grid = torch.zeros(n_voxels + 1, dtype=f32, device=dev)
    grid.index_add_(0, torch.cat(indices), torch.cat(weights))
    return grid[:n_voxels].reshape(ht, wd, ch)
