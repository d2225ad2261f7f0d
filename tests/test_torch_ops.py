"""Port parity: ops (sampler, Bezier curves, convex upsampling) against
the JAX package on identical numpy-seeded inputs. f32, rtol=atol=1e-5."""

from __future__ import annotations

from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.ops import bezier as jbez
from bflow_tpu.ops import sampler as jsam
from bflow_tpu.ops import upsample as jup
from bflow_tpu_torch.ops import bezier as tbez
from bflow_tpu_torch.ops import sampler as tsam
from bflow_tpu_torch.ops import upsample as tup
from bflow_tpu_torch.utils.precision import full_f32
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 8, 8), (3, 7, 10)])
def test_coords_grid(shape):
    got = tsam.coords_grid(*shape).numpy()
    want = np.asarray(jsam.coords_grid(*shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,H,W,spread", [
    (3, 9, 11, 3.0),      # in-map and edge-straddling points
    (2, 7, 10, 1e4),      # mostly far outside the map
    (4, 1, 6, 2.0),       # single-row maps
])
def test_bilinear_sample(B, H, W, spread):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((B, H, W)).astype(np.float32)
    centre = np.array([W / 2, H / 2], np.float32)
    coords = (centre + spread * rng.uniform(-1, 1, (B, 5, 6, 2))).astype(
        np.float32)
    coords[:, 0, 0] = [0.0, 0.0]              # exact corners
    coords[:, 0, 1] = [W - 1.0, H - 1.0]
    coords[:, 0, 2] = [-0.5, H - 0.5]         # half outside
    got = tsam.bilinear_sample(torch.from_numpy(img),
                               torch.from_numpy(coords)).numpy()
    want = np.asarray(jsam.bilinear_sample(jnp.asarray(img),
                                           jnp.asarray(coords)))
    assert got.shape == want.shape == (B, 5, 6)
    np.testing.assert_allclose(got, want, **TOL)


def test_bilinear_sample_matches_grid_sample():
    """align_corners=True, zero padding: the reference sampler's meaning."""
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    B, H, W = 2, 6, 9
    img = torch.from_numpy(rng.standard_normal((B, H, W)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-2, 11, (B, 4, 5, 2)).astype(
        np.float32))
    grid = torch.stack([2 * coords[..., 0] / (W - 1) - 1,
                        2 * coords[..., 1] / (H - 1) - 1], dim=-1)
    want = F.grid_sample(img[:, None], grid, align_corners=True,
                         padding_mode="zeros")[:, 0]
    got = tsam.bilinear_sample(img, coords)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("degree", [1, 2, 10])
def test_bezier_coefficients(degree):
    ts = (0.0, 0.1, 1 / 3, 0.5, 0.9, 1.0)
    np.testing.assert_array_equal(
        tbez.bezier_coefficients(degree, ts),
        jbez.bezier_coefficients(degree, ts))


@pytest.mark.parametrize("times", [0.0, 1.0, 0.37, (0.0, 0.25, 0.5, 1.0),
                                   (1 / 14, 2 / 14, 3 / 14, 4 / 14, 1.0)])
@pytest.mark.parametrize("degree", [2, 10])
def test_bezier_flow_at(times, degree):
    rng = np.random.default_rng(3)
    params = rng.standard_normal((2, 4, 5, degree, 2)).astype(np.float32) * 5
    got = tbez.BezierCurves(torch.from_numpy(params)).flow_at(times)
    want = jbez.BezierCurves(jnp.asarray(params)).flow_at(times)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


INTERIOR = tuple(i / 10 for i in range(1, 10))
TIMES = (0.0,) + INTERIOR + (1.0,)


def _flow_at_uncached(params, t):
    """flow_at at one time with the coefficients copied to the params'
    device in every call: the formula the cache must reproduce."""
    if t == 0.0:
        return torch.zeros_like(params[..., 0, :])
    if t == 1.0:
        return params[..., -1, :]
    coeff = torch.as_tensor(
        tbez.bezier_coefficients(params.shape[3], (t,))[0],
        dtype=params.dtype, device=params.device)
    with full_f32():
        return torch.einsum("nhwpd,p->nhwd", params, coeff)


@pytest.fixture
def coeff_cache(monkeypatch):
    """An empty coefficient cache and zeroed counters for the case."""
    monkeypatch.setattr(tbez, "_coeffs", OrderedDict())
    tbez.reset_counters()
    yield tbez
    tbez.reset_counters()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("degree", [1, 2, 10])
@pytest.mark.parametrize("call", ["scalar", "sequence"])
def test_bezier_flow_at_cached_equals_uncached(coeff_cache, call, degree,
                                               dtype):
    """The cached coefficients give flow_at bit for bit the flows of a
    host copy per call; the first call misses once per time strictly
    inside (0, 1), the second only hits."""
    params = (torch.from_numpy(np.random.default_rng(degree).standard_normal(
        (2, 3, 4, degree, 2)).astype(np.float32)) * 5).to(dtype)
    curve = tbez.BezierCurves(params)
    want = torch.stack([_flow_at_uncached(params, t) for t in TIMES])

    def flows():
        if call == "scalar":
            return torch.stack([curve.flow_at(t) for t in TIMES])
        return curve.flow_at(TIMES)

    for n in (1, 2):
        got = flows()
        assert got.dtype == dtype and torch.equal(got, want)
        assert coeff_cache.coeff_misses == len(INTERIOR)
        assert coeff_cache.coeff_hits == (n - 1) * len(INTERIOR)
    assert set(coeff_cache._coeffs) == {(degree, t, dtype, params.device)
                                        for t in INTERIOR}


def test_bezier_coeff_cache_stays_within_its_bound(coeff_cache,
                                                   monkeypatch):
    """Past COEFF_CACHE_SIZE distinct times the least recently used
    entry goes; results stay equal to the uncached formula."""
    monkeypatch.setattr(tbez, "COEFF_CACHE_SIZE", 8)
    params = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 2, 3, 3, 2)).astype(np.float32))
    curve = tbez.BezierCurves(params)
    times = [i / 41 for i in range(1, 41)]
    for i, t in enumerate(times):
        assert torch.equal(curve.flow_at(t), _flow_at_uncached(params, t))
        curve.flow_at(times[0])  # kept: the most recently used
        assert len(coeff_cache._coeffs) == min(i + 1, 8)
    misses = coeff_cache.coeff_misses
    assert misses == len(times)
    curve.flow_at(times[0])
    curve.flow_at(times[-1])
    assert coeff_cache.coeff_misses == misses  # both still cached
    assert torch.equal(curve.flow_at(times[1]),
                       _flow_at_uncached(params, times[1]))
    assert coeff_cache.coeff_misses == misses + 1  # evicted long ago
    assert len(coeff_cache._coeffs) == 8


def test_bezier_coeffs_cached_under_inference_mode_serve_a_backward(
        coeff_cache):
    """Coefficients first made under torch.inference_mode can be saved by
    a later call that records a backward."""
    params = torch.ones(1, 2, 2, 2, 2)
    with torch.inference_mode():
        tbez.BezierCurves(params).flow_at(0.25)
    leaf = params.clone().requires_grad_()
    tbez.BezierCurves(leaf).flow_at(0.25).sum().backward()
    assert coeff_cache.coeff_hits == coeff_cache.coeff_misses == 1
    want = torch.as_tensor(tbez.bezier_coefficients(2, (0.25,))[0],
                           dtype=torch.float32)
    assert torch.equal(leaf.grad[0, 0, 0, :, 0], want)


def test_bezier_zeros_and_delta_update():
    rng = np.random.default_rng(4)
    delta = rng.standard_normal((1, 3, 4, 2, 2)).astype(np.float32)
    t = tbez.BezierCurves.zeros(1, 3, 4, 2).delta_update(
        torch.from_numpy(delta))
    j = jbez.BezierCurves.zeros(1, 3, 4, 2).delta_update(jnp.asarray(delta))
    np.testing.assert_array_equal(t.params.numpy(), np.asarray(j.params))
    assert t.degree == j.degree == 2


def test_bezier_from_flow_and_metadata():
    """tests/test_ops_bezier.py:85-91 for both packages: the degree-1 curve
    of a two-view flow is linear in t; the shape and dtype accessors."""
    flow = np.random.default_rng(5).standard_normal(
        (1, 4, 6, 2)).astype(np.float32)
    t = tbez.BezierCurves.from_flow(torch.from_numpy(flow))
    j = jbez.BezierCurves.from_flow(jnp.asarray(flow))
    np.testing.assert_array_equal(t.params.numpy(), np.asarray(j.params))
    np.testing.assert_allclose(t.flow_at(0.5).numpy(),
                               np.asarray(j.flow_at(0.5)), **TOL)
    np.testing.assert_allclose(t.flow_at(0.5).numpy(), 0.5 * flow,
                               rtol=1e-6)
    assert ((t.batch, t.height, t.width, t.degree)
            == (j.batch, j.height, j.width, j.degree) == (1, 4, 6, 1))
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    assert t.astype(torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tbez.BezierCurves.from_flow(torch.zeros(1, 4, 6, 3))


@pytest.mark.parametrize("factor", [2, 8])
def test_bezier_upsampled(factor):
    rng = np.random.default_rng(5)
    params = rng.standard_normal((1, 4, 6, 2, 2)).astype(np.float32)
    mask = rng.standard_normal((1, 4, 6, 9 * factor * factor)).astype(
        np.float32)
    got = tbez.BezierCurves(torch.from_numpy(params)).upsampled(
        torch.from_numpy(mask), factor)
    want = jbez.BezierCurves(jnp.asarray(params)).upsampled(
        jnp.asarray(mask), factor)
    assert tuple(got.params.shape) == (1, 4 * factor, 6 * factor, 2, 2)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               **TOL)


@pytest.mark.parametrize("N,H,W,D", [(1, 5, 7, 4), (2, 3, 3, 2)])
def test_convex_upsample(N, H, W, D):
    rng = np.random.default_rng(6)
    data = rng.standard_normal((N, H, W, D)).astype(np.float32)
    mask = (3 * rng.standard_normal((N, H, W, 576))).astype(np.float32)
    got = tup.convex_upsample(torch.from_numpy(data), torch.from_numpy(mask))
    want = jup.convex_upsample(jnp.asarray(data), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convex_upsample_channel_layout():
    """Mask channel c = k*64 + i*8 + j: a one-hot logit on neighbour k for
    sub-pixel (i, j) copies that neighbour, x8, into that sub-pixel."""
    data = torch.arange(9, dtype=torch.float32).reshape(1, 3, 3, 1)
    mask = torch.zeros(1, 3, 3, 576)
    k, i, j = 5, 2, 7                       # neighbour (ky, kx) = (1, 2)
    mask[0, 1, 1, :] = -1e4
    mask[0, 1, 1, k * 64 + i * 8 + j] = 1e4
    up = tup.convex_upsample(data, mask)
    assert up[0, 8 + i, 8 + j, 0].item() == 8 * data[0, 1, 2, 0].item()
