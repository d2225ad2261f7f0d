"""Port parity of the on-device voxelizer (bflow_tpu_torch.ops.voxelize vs
bflow_tpu.ops.voxelize), run here on CPU tensors.

Bounds: 1e-5 abs against the JAX function (the same f32 arithmetic, the
sums in another order); 1e-4 against the host rasterizer, the bound of
tests/test_voxelize_device.py (the host rasterizer computes time and
weights in f64). Times are window-relative: both device functions cast t
to f32 before subtracting t0, which at absolute DSEC microsecond
timestamps loses whole bins. On CUDA the scatter adds with float atomics:
two runs agree to within these bounds, not bitwise (the GPU case below).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bflow_tpu_torch.data.representations import VoxelGrid
from bflow_tpu_torch.ops.voxelize import voxelize_events
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

CH, HT, WD = 5, 16, 20


def events(int_xy: bool, n=3000, cap=4096, seed=0):
    """Padded event arrays (capacity cap, the first n valid)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 100000, n)).astype(np.int64)
    pol = rng.integers(0, 2, n).astype(np.float32)
    if int_xy:
        x = rng.integers(0, WD, n).astype(np.int32)
        y = rng.integers(0, HT, n).astype(np.int32)
    else:
        x = rng.uniform(-0.5, WD - 0.5, n).astype(np.float32)
        y = rng.uniform(-0.5, HT - 0.5, n).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    pad = [np.pad(a, (0, cap - n)) for a in (x, y, pol, t)]
    return (x, y, pol, t), (*pad, valid)


def port(padded, t0, t1, device="cpu"):
    x, y, pol, t, valid = (torch.from_numpy(a).to(device) for a in padded)
    return voxelize_events(x, y, pol, t, valid, t0, t1, channels=CH,
                           height=HT, width=WD)


@pytest.mark.parametrize("int_xy", [True, False])
def test_matches_jax(int_xy):
    import jax.numpy as jnp

    from bflow_tpu.ops.voxelize import voxelize_events as jax_voxelize

    _, padded = events(int_xy)
    t0, t1 = 10000, 90000
    want = np.asarray(jax_voxelize(
        *(jnp.asarray(a) for a in padded), jnp.asarray(t0), jnp.asarray(t1),
        channels=CH, height=HT, width=WD))
    got = port(padded, t0, t1)
    assert got.shape == (HT, WD, CH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("int_xy", [True, False])
def test_matches_host_grid(int_xy):
    raw, padded = events(int_xy, seed=1)
    t0, t1 = 10000, 90000
    want = VoxelGrid(CH, HT, WD).convert(*raw, t0, t1)  # (C, H, W)
    got = port(padded, torch.tensor(t0), torch.tensor(t1))
    np.testing.assert_allclose(got.numpy().transpose(2, 0, 1), want,
                               rtol=1e-4, atol=1e-4)


def test_all_padding_gives_zero_grid():
    cap = 128
    z = torch.zeros(cap, dtype=torch.int32)
    got = voxelize_events(z, z, torch.zeros(cap), z,
                          torch.zeros(cap, dtype=torch.bool), 0, 1000,
                          channels=3, height=8, width=8)
    assert torch.equal(got, torch.zeros(8, 8, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("int_xy", [True, False])
def test_cuda_matches_host_grid(int_xy):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the scatter runs on the card")
    raw, padded = events(int_xy, seed=2)
    want = VoxelGrid(CH, HT, WD).convert(*raw, 10000, 90000)
    runs = [port(padded, 10000, 90000, "cuda").cpu() for _ in range(2)]
    for got in runs:
        np.testing.assert_allclose(got.numpy().transpose(2, 0, 1), want,
                                   rtol=1e-4, atol=1e-4)
    # float atomics: repeatable to round-off, not bitwise
    np.testing.assert_allclose(runs[0].numpy(), runs[1].numpy(), rtol=0,
                               atol=1e-5)
