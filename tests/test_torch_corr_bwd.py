"""Port parity of the lookup's VJP: the plain backward
(corr_lookup_level_bwd_plain, the CUDA backward kernel's CPU twin and
oracle) against jax.grad of the JAX gather lookup and against the Pallas
TPU backward kernel (_bwd_kernel, through lookup_level_slab's custom VJP)
in interpret mode.

Coordinates include exact integers at -1, 0, w-1 and w (where the
derivative is the right derivative, the TPU kernel's _dhat) and points at
+-1e4. Bounds: f32 dvol rtol 1e-4 / atol 1e-5, dcoords rtol 1e-4 /
atol 2e-4 (the JAX package's own, tests/test_corr_v3.py: the Pallas
kernel sums through hat-matrix products, in another order); bf16 against
the JAX gather on the same bf16 volume: 1e-2 of max |ref| (the gather
accumulates its corners in bf16, the twin in f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.models.corr import _lookup_level_gather
from bflow_tpu.ops.pallas.corr_lookup_v3 import lookup_level_slab, to_slab
from bflow_tpu_torch.kernels import corr_lookup as klookup
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

# (T, N, h1, w1, hl, wl, r): tests/test_corr_v3.py's VJP shapes, the
# forward parity shapes, and a flagship-like level 0 (60x80 maps)
CASES = [
    (2, 1, 4, 10, 30, 14, 4),
    (1, 1, 3, 7, 16, 12, 3),
    (2, 1, 6, 16, 30, 18, 4),
    (1, 2, 5, 10, 16, 9, 2),
    (1, 1, 4, 8, 60, 80, 4),
]


def _case(seed, T, N, h1, w1, hl, wl, r):
    """Volume, coords (a third on exact integers, incl. -1, 0, w-1, w;
    one in ten at +-1e4) and a cotangent."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((T, N, h1, w1, hl, wl)).astype(np.float32)
    shape = (T, N, h1, w1)
    x = rng.uniform(-4, wl + 3, shape)
    y = rng.uniform(-4, hl + 3, shape)
    on_int = rng.random(shape) < 0.33
    x = np.where(on_int, rng.choice([-1, 0, 3, wl - 1, wl], shape), x)
    y = np.where(on_int, rng.choice([-1, 0, 2, hl - 1, hl], shape), y)
    coords = np.stack([x, y], -1).astype(np.float32)
    far = rng.random(shape) < 0.1
    coords[far] = rng.choice([-1e4, 1e4], size=(far.sum(), 2))
    g = rng.standard_normal(shape + ((2 * r + 1) ** 2,)).astype(np.float32)
    return vol, coords, g


def _pad_rows16(vol):
    hl = vol.shape[4]
    hp = ((hl + 15) // 16) * 16
    out = np.zeros(vol.shape[:4] + (hp, vol.shape[5]), vol.dtype)
    out[..., :hl, :] = vol
    return out


def _port_vjp(vol, coords, g, r, dtype=torch.float32):
    T, N, h1, w1, hl, wl = vol.shape
    dv, dc = klookup.corr_lookup_level_bwd_plain(
        torch.from_numpy(vol.reshape(-1, hl, wl)).to(dtype),
        torch.from_numpy(coords.reshape(-1, 2)),
        torch.from_numpy(g.reshape(-1, (2 * r + 1) ** 2)).to(dtype), r)
    assert dv.dtype == dtype and dc.dtype == torch.float32
    return (dv.float().numpy().reshape(vol.shape),
            dc.numpy().reshape(coords.shape))


def _jax_vjp(lookup, vol, coords, g):
    """jax.grad of sum(lookup(vol, coords) * g) in (vol, coords), jitted."""
    def f(v, c):
        return (lookup(v, c).astype(jnp.float32) * g).sum()

    dv, dc = jax.jit(jax.grad(f, argnums=(0, 1)))(vol, jnp.asarray(coords))
    return np.asarray(dv, np.float32), np.asarray(dc)


@pytest.fixture(scope="module")
def jax_vjps():
    """Per case: the inputs and the VJPs of the JAX gather (f32 and bf16)
    and of the Pallas kernel in interpret mode."""
    out = {}
    for i, case in enumerate(CASES):
        T, N, h1, w1, hl, wl, r = case
        vol, coords, g = _case(i, *case)
        gather = lambda v, c: _lookup_level_gather(v, c, r)  # noqa: E731
        pallas = lambda v, c: lookup_level_slab(  # noqa: E731
            to_slab(v), c, r, True)
        out[case] = {
            "inputs": (vol, coords, g),
            "gather": _jax_vjp(gather, jnp.asarray(vol), coords, g),
            "gather_bf16": _jax_vjp(gather, jnp.asarray(vol, jnp.bfloat16),
                                    coords, g),
            "pallas": _jax_vjp(pallas, jnp.asarray(_pad_rows16(vol)),
                               coords, g),
        }
    return out


def _assert_f32(got, want, hl):
    (dv, dc), (wv, wc) = got, want
    np.testing.assert_allclose(dv, wv[..., :hl, :], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dc, wc, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_jax_gather(jax_vjps, case):
    vol, coords, g = jax_vjps[case]["inputs"]
    got = _port_vjp(vol, coords, g, case[-1])
    assert np.abs(got[0]).max() > 0 and np.abs(got[1]).max() > 0
    _assert_f32(got, jax_vjps[case]["gather"], case[4])


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_pallas_interpret(jax_vjps, case):
    vol, coords, g = jax_vjps[case]["inputs"]
    got = _port_vjp(vol, coords, g, case[-1])
    _assert_f32(got, jax_vjps[case]["pallas"], case[4])


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_bf16_matches_jax_gather(jax_vjps, case):
    vol, coords, g = jax_vjps[case]["inputs"]
    # the same bf16 volume and cotangent on both sides
    vol16 = np.asarray(jnp.asarray(vol, jnp.bfloat16), np.float32)
    g16 = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    dv, dc = _port_vjp(vol16, coords, g16, case[-1], torch.bfloat16)
    wv, wc = jax_vjps[case]["gather_bf16"]
    for got, want in ((dv, wv), (dc, wc)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


def test_plain_bwd_right_derivative_at_integers():
    """At an integer x the derivative is the right one, v[x+1] - v[x],
    and the cotangent of a tap on an integer lands on one cell."""
    r = 1
    vol = np.arange(20, dtype=np.float32).reshape(1, 4, 5) ** 2
    coords = np.array([[2.0, 1.0]], np.float32)
    g = np.zeros((1, 9), np.float32)
    g[0, 4] = 1.0  # the centre tap, at (2, 1) exactly
    dv, dc = klookup.corr_lookup_level_bwd_plain(
        torch.from_numpy(vol), torch.from_numpy(coords),
        torch.from_numpy(g), r)
    want_v = np.zeros_like(vol)
    want_v[0, 1, 2] = 1.0
    np.testing.assert_array_equal(dv.numpy(), want_v)
    np.testing.assert_allclose(
        dc.numpy()[0], [vol[0, 1, 3] - vol[0, 1, 2],
                        vol[0, 2, 2] - vol[0, 1, 2]])


def test_plain_bwd_bf16_rounds_dvol_once():
    """A bf16 volume's dvol is the f32 VJP rounded once to bf16; its
    dcoords is the f32 one."""
    vol, coords, g = _case(7, 1, 1, 3, 5, 12, 9, 4)
    v = torch.from_numpy(vol.reshape(-1, 12, 9)).bfloat16()
    c = torch.from_numpy(coords.reshape(-1, 2))
    gg = torch.from_numpy(g.reshape(-1, 81)).bfloat16()
    dv, dc = klookup.corr_lookup_level_bwd_plain(v, c, gg, 4)
    wv, wc = klookup.corr_lookup_level_bwd_plain(v.float(), c, gg.float(), 4)
    assert dv.dtype == torch.bfloat16
    assert torch.equal(dv, wv.bfloat16()) and torch.equal(dc, wc)


def test_cpu_wrapper_gradient_is_the_plain_vjp():
    """On CPU tensors corr_lookup_level is the plain lookup, and autograd
    through it gives the twin's VJP, bit for bit, without a launch."""
    vol, coords, g = _case(8, 2, 1, 3, 5, 10, 11, 4)
    v = torch.from_numpy(vol.reshape(-1, 10, 11)).requires_grad_(True)
    c = torch.from_numpy(coords.reshape(-1, 2)).requires_grad_(True)
    gg = torch.from_numpy(g.reshape(-1, 81))
    before = (klookup.launches, klookup.bwd_launches)
    out = klookup.corr_lookup_level(v, c, 4)
    dv, dc = torch.autograd.grad(out, (v, c), gg)
    wv, wc = klookup.corr_lookup_level_bwd_plain(v, c, gg, 4)
    assert torch.equal(dv, wv) and torch.equal(dc, wc)
    assert (klookup.launches, klookup.bwd_launches) == before


def test_plain_bwd_of_empty_level_is_zero():
    vol = torch.zeros(6, 0, 4)
    coords = torch.ones(6, 2)
    dv, dc = klookup.corr_lookup_level_bwd_plain(vol, coords,
                                                 torch.ones(6, 81), 4)
    assert dv.shape == vol.shape and not dc.any()
