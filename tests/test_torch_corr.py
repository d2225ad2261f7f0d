"""Port parity: correlation volumes, pyramid and the windowed lookup.

The port's plain lookup (the CUDA kernel's CPU twin) is held against the
JAX gather oracle and against the Pallas TPU kernel run in interpret mode,
f32 rtol=1e-4, atol=1e-5 (the Pallas kernel blends through hat-weight
matmuls, so sums differ in order from the gather)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.models import corr as jcorr
from bflow_tpu.ops.pallas.corr_lookup_v3 import lookup_level_slab, to_slab
from bflow_tpu_torch.kernels import corr_lookup as klookup
from bflow_tpu_torch.models import corr as tcorr
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

# tests/test_corr_v3.py shapes (T, N, h1, w1, hl, wl, r), plus deep-level
# maps with ragged query rows
LOOKUP_CASES = [
    (2, 1, 6, 16, 30, 18, 4),
    (1, 2, 5, 10, 16, 9, 2),
    (1, 1, 4, 7, 13, 11, 3),
    (2, 1, 3, 8, 60, 20, 4),
    (2, 1, 3, 5, 7, 10, 4),
]


def _lookup_case(seed, T, N, h1, w1, hl, wl, far=False):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((T, N, h1, w1, hl, wl)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-4, wl + 3, (T, N, h1, w1)),
         rng.uniform(-4, hl + 3, (T, N, h1, w1))], -1).astype(np.float32)
    if far:  # random-init flows reach hundreds of pixels
        pick = rng.random((T, N, h1, w1)) < 0.5
        coords[pick] = rng.choice([-1e4, 1e4, -300.0, 450.0],
                                  size=(pick.sum(), 2))
    return vol, coords


def _pad_rows16(vol):
    hl = vol.shape[4]
    hp = ((hl + 15) // 16) * 16
    out = np.zeros(vol.shape[:4] + (hp, vol.shape[5]), np.float32)
    out[..., :hl, :] = vol
    return out


def _port_lookup(fn, vol, coords, r):
    T, N, h1, w1, hl, wl = vol.shape
    out = fn(torch.from_numpy(vol.reshape(-1, hl, wl)),
             torch.from_numpy(coords.reshape(-1, 2)), r)
    return out.reshape(T, N, h1, w1, -1).numpy()


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_plain_lookup_matches_jax_gather(case, far):
    T, N, h1, w1, hl, wl, r = case
    vol, coords = _lookup_case(0, T, N, h1, w1, hl, wl, far)
    got = _port_lookup(klookup.corr_lookup_level_plain, vol, coords, r)
    want = np.asarray(jcorr._lookup_level_gather(
        jnp.asarray(_pad_rows16(vol)), jnp.asarray(coords), r))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,far", [(c, False) for c in LOOKUP_CASES[:4]]
                         + [(LOOKUP_CASES[0], True)])
def test_plain_lookup_matches_pallas_interpret(case, far):
    T, N, h1, w1, hl, wl, r = case
    vol, coords = _lookup_case(1, T, N, h1, w1, hl, wl, far)
    got = _port_lookup(klookup.corr_lookup_level_plain, vol, coords, r)
    want = np.asarray(lookup_level_slab(
        to_slab(jnp.asarray(_pad_rows16(vol))), jnp.asarray(coords), r,
        True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    vol, coords = _lookup_case(2, 2, 1, 3, 5, 7, 10, far=True)
    before = klookup.launches
    a = _port_lookup(klookup.corr_lookup_level, vol, coords, 4)
    b = _port_lookup(klookup.corr_lookup_level_plain, vol, coords, 4)
    np.testing.assert_array_equal(a, b)
    assert klookup.launches == before  # no kernel launch on the CPU


def test_plain_lookup_bf16_rounds_once():
    """bf16 volumes blend in f32 and round once to bf16."""
    vol, coords = _lookup_case(3, 1, 1, 4, 6, 12, 9)
    v16 = torch.from_numpy(vol.reshape(-1, 12, 9)).bfloat16()
    c = torch.from_numpy(coords.reshape(-1, 2))
    got = klookup.corr_lookup_level_plain(v16, c, 4)
    want = klookup.corr_lookup_level_plain(v16.float(), c, 4).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["radius", "dtype", "coords_dtype", "shape",
                                 "rank"])
def test_wrapper_rejects_bad_inputs(bad):
    vol = torch.zeros(6, 5, 7)
    coords = torch.zeros(6, 2)
    r = 4
    if bad == "radius":
        r = 8  # 2r+2 = 18 > 16
    elif bad == "dtype":
        vol = vol.half()
    elif bad == "coords_dtype":
        coords = coords.double()
    elif bad == "shape":
        coords = torch.zeros(5, 2)
    elif bad == "rank":
        vol = vol[None]
    with pytest.raises((ValueError, TypeError)):
        klookup.corr_lookup_level(vol, coords, r)


def _fmaps(seed, T=5, N=1, h=8, w=8, D=16):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((T, N, h, w, D)).astype(np.float32)
    tgt = rng.standard_normal((T, N, h, w, D)).astype(np.float32)
    return ref, tgt


@pytest.mark.parametrize("hk,wk", [(8, 8), (4, 4), (3, 5)])
def test_all_pairs_correlation_f32(hk, wk):
    ref, tgt = _fmaps(4)
    tgt = tgt[:, :, :hk, :wk]
    got = tcorr.all_pairs_correlation(torch.from_numpy(ref),
                                      torch.from_numpy(tgt)).numpy()
    want = np.asarray(jcorr.all_pairs_correlation(jnp.asarray(ref),
                                                  jnp.asarray(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_all_pairs_correlation_bf16():
    """bf16 operands, f32 accumulation, bf16 volume: agrees with the JAX
    bf16 volume up to one bf16 rounding of the result."""
    ref, tgt = _fmaps(5)
    got = tcorr.all_pairs_correlation(
        torch.from_numpy(ref).bfloat16(), torch.from_numpy(tgt).bfloat16(),
        "bfloat16")
    want = jcorr.all_pairs_correlation(
        jnp.asarray(ref, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16),
        "bfloat16")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("levels", [(1, 1, 1, 4, 4), (1, 1, 1, 1, 2), (3,)])
def test_level_target_indices(levels):
    assert tcorr.level_target_indices(levels) == \
        jcorr.level_target_indices(levels)


@pytest.mark.parametrize("h,w", [(8, 8), (10, 14), (4, 4)])
def test_build_corr_pyramid_matches(h, w):
    """Same volumes as the JAX pyramid once its zero pad rows are cut."""
    levels = (1, 1, 1, 4, 4)
    ref, tgt = _fmaps(6, h=h, w=w)
    got = tcorr.build_corr_pyramid(torch.from_numpy(ref),
                                   torch.from_numpy(tgt), levels)
    want = jcorr.build_corr_pyramid(jnp.asarray(ref), jnp.asarray(tgt),
                                    levels)
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi == wi
        hl = gv.shape[4]
        wv = np.asarray(wv)
        assert not wv[..., hl:, :].any()  # JAX pad rows are zero
        np.testing.assert_allclose(gv.numpy(), wv[..., :hl, :], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["gather", "pallas"])
@pytest.mark.parametrize("concat", [True, False])
def test_corr_lookup_matches_jax_gather(method, concat):
    """Channel contract (level, target, window) in both output forms."""
    levels = (1, 1, 1, 4, 4)
    ref, tgt = _fmaps(7)
    rng = np.random.default_rng(8)
    coords = (rng.uniform(-3, 11, (5, 1, 8, 8, 2))).astype(np.float32)
    t_pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref),
                                     torch.from_numpy(tgt), levels)
    j_pyr = jcorr.build_corr_pyramid(jnp.asarray(ref), jnp.asarray(tgt),
                                     levels)
    got = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), 4,
                            method=method, concat=concat)
    want = jcorr.corr_lookup(j_pyr, jnp.asarray(coords), 4,
                             method="gather", concat=concat)
    if concat:
        assert tuple(got.shape) == (1, 8, 8, (5 + 2 * 3) * 81)
        got, want = [got], [want]
    else:
        assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_corr_lookup_refuses_unported_methods():
    """Every lookup method of the JAX package is ported now
    (tests/test_torch_corr_q8.py); a name it does not have, such as the
    removed 'pallas_v2', is refused."""
    assert set(tcorr.METHODS) == {"auto", "pallas", "pallas_q8", "gather",
                                  "onehot"}
    with pytest.raises(NotImplementedError, match="lookup methods"):
        tcorr.corr_lookup([], torch.zeros(1, 1, 2, 2, 2), 4,
                          method="pallas_v2")


# the v6 forward (_fwd_kernel_v6, selected by BFLOW_LOOKUP_V6=1, read at
# call time) in interpret mode against the port's plain lookup: map widths
# that are multiples of 16 and ones that are not
V6_CASES = [
    (1, 1, 4, 8, 30, 32, 4),
    (2, 1, 3, 8, 16, 16, 3),
    (2, 1, 6, 16, 30, 18, 4),
    (1, 2, 5, 10, 16, 9, 2),
]


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("case", V6_CASES)
def test_plain_lookup_matches_pallas_v6_interpret(case, far, monkeypatch):
    monkeypatch.setenv("BFLOW_LOOKUP_V6", "1")
    T, N, h1, w1, hl, wl, r = case
    vol, coords = _lookup_case(9, T, N, h1, w1, hl, wl, far)
    got = _port_lookup(klookup.corr_lookup_level_plain, vol, coords, r)
    want = np.asarray(lookup_level_slab(
        to_slab(jnp.asarray(_pad_rows16(vol))), jnp.asarray(coords), r,
        True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
