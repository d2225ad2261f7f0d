"""Port parity: the int8 volume lookup (lookup_method='pallas_q8'), the
one-hot lookup and the mixed dispatch (onehot_from_level) against the JAX
package: quantize_volume, lookup_level_slab_q8 run in interpret mode,
_lookup_level_onehot and corr_lookup.

Tolerances, stated where they are used:
  * int8 volume: equal, except where v * inv lands on a rounding tie in
    one package and not in the other (XLA may keep the product in f32);
    such elements differ by one and are counted;
  * q8 lookup: the TPU kernel blends the integers in two bf16-rounded
    stages with bf16 hat weights and multiplies by the bf16-rounded scale;
    the port blends in f32 and rounds once, so outputs differ by a few
    bf16 ulps: 2^-6 of max |JAX| (four ulps at the top of the range);
  * one-hot: both select the patch exactly and blend in f32: f32 rtol
    1e-5, atol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.models import corr as jcorr
from bflow_tpu.ops.pallas import corr_lookup_v3 as jv3
from bflow_tpu_torch.kernels import corr_lookup as klookup
from bflow_tpu_torch.models import corr as tcorr
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_corr import LOOKUP_CASES, _lookup_case, _pad_rows16

# tests/test_corr_v3.py:53-57 shapes (T, N, h1, w1, hl, wl, r)
Q8_CASES = [(2, 1, 6, 16, 30, 18, 4), (1, 1, 4, 8, 60, 20, 4),
            (1, 1, 3, 8, 46, 62, 4)]


def _bf16_volume(seed, T, N, h1, w1, hl, wl, far=False):
    vol, coords = _lookup_case(seed, T, N, h1, w1, hl, wl, far)
    vol = (3.0 * vol).astype(np.float32)
    return torch.from_numpy(vol).bfloat16(), coords


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", Q8_CASES)
def test_quantize_volume_matches_jax(case, dtype):
    T, N, h1, w1, hl, wl, _ = case
    vol, _ = _bf16_volume(0, T, N, h1, w1, hl, wl)
    vol = vol.to(dtype)
    q, scale = klookup.quantize_volume(vol)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jscale = jv3.quantize_volume(jnp.asarray(
        _pad_rows16(vol.float().numpy()), jdt))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == (T, N, h1)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    want = np.asarray(jq)[..., :hl, :].astype(np.int32)
    diff = np.abs(q.numpy().astype(np.int32) - want)
    assert diff.max() <= 1
    # an element off by one sits on a rounding tie of v * inv: count them
    ties = np.abs(np.abs(vol.float().numpy() * (1.0 / scale.numpy())[
        ..., None, None, None]) % 1.0 - 0.5) < 1e-2
    assert (diff > 0).sum() <= ties.sum()
    assert (diff > 0).mean() < 1e-3
    assert not np.asarray(jq)[..., hl:, :].any()  # JAX's pad rows stay 0


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("case", Q8_CASES)
def test_q8_plain_lookup_matches_pallas_interpret(case, far):
    T, N, h1, w1, hl, wl, r = case
    vol, coords = _bf16_volume(1, T, N, h1, w1, hl, wl, far)
    q, scale = klookup.quantize_volume(vol)
    Q = T * N * h1 * w1
    got = klookup.corr_lookup_level_q8_plain(
        q.reshape(Q, hl, wl), scale, torch.from_numpy(coords.reshape(Q, 2)),
        r)
    assert got.dtype == torch.bfloat16
    qp = np.zeros((T, N, h1, w1, -(-hl // 16) * 16, wl), np.int8)
    qp[..., :hl, :] = q.numpy()
    want = jv3.lookup_level_slab_q8(
        jv3.to_slab(jnp.asarray(qp)), jnp.asarray(scale.numpy()),
        jnp.asarray(coords), r, True)
    want = np.asarray(want, np.float32)
    got = got.float().numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())
    if far:
        assert (want == 0).all(axis=-1).any()  # whole windows off the map


def test_q8_plain_is_the_dequantized_gather():
    """The port's q8 function: the f32 gather of the integers, times the
    row's scale, rounded once to bf16."""
    vol, coords = _bf16_volume(2, 2, 1, 3, 5, 30, 18, far=True)
    q, scale = klookup.quantize_volume(vol)
    Q = 2 * 3 * 5
    c = torch.from_numpy(coords.reshape(Q, 2))
    got = klookup.corr_lookup_level_q8_plain(q.reshape(Q, 30, 18), scale, c, 4)
    taps = klookup.corr_lookup_level_plain(q.reshape(Q, 30, 18).float(), c, 4)
    rows = scale.reshape(-1).repeat_interleave(5)[:, None]
    assert torch.equal(got, (taps * rows).bfloat16())


def test_q8_wrapper_raises_under_autograd_and_on_bad_inputs():
    vol, coords = _bf16_volume(3, 1, 1, 2, 4, 20, 12)
    q, scale = klookup.quantize_volume(vol)
    q = q.reshape(8, 20, 12)
    c = torch.from_numpy(coords.reshape(8, 2))
    before = klookup.q8_launches
    out = klookup.corr_lookup_level_q8(q, scale, c, 4)
    assert klookup.q8_launches == before  # the CPU takes the plain version
    assert torch.equal(out, klookup.corr_lookup_level_q8_plain(q, scale, c,
                                                               4))
    with pytest.raises(RuntimeError, match="inference only"):
        klookup.corr_lookup_level_q8(q, scale, c.requires_grad_(True), 4)
    c = c.detach()
    for bad in (dict(vol=q.float()), dict(scale=scale.double()),
                dict(scale=scale.reshape(-1)[:1].repeat(3)),
                dict(coords=c[:5]), dict(radius=8)):
        args = {**dict(vol=q, scale=scale, coords=c, radius=4), **bad}
        with pytest.raises((ValueError, TypeError)):
            klookup.corr_lookup_level_q8(**args)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_onehot_lookup_matches_jax(case, far, precision):
    T, N, h1, w1, hl, wl, r = case
    vol, coords = _lookup_case(4, T, N, h1, w1, hl, wl, far)
    got = tcorr.lookup_level_onehot(torch.from_numpy(vol),
                                    torch.from_numpy(coords), r, precision)
    want = np.asarray(jcorr._lookup_level_onehot(
        jnp.asarray(_pad_rows16(vol)), jnp.asarray(coords), r, precision))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _pyramids(seed, h=18, w=8, precision="float32"):
    """The port's and the JAX package's pyramids of the same features:
    5 targets, levels (1, 1, 1, 4, 4), an 18x8 query grid (level 0 has
    18 rows, which pads to 32: quantized; level 1 has 9: not)."""
    levels = (1, 1, 1, 4, 4)
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((5, 1, h, w, 16)).astype(np.float32)
    tgt = rng.standard_normal((5, 1, h, w, 16)).astype(np.float32)
    coords = np.stack([rng.uniform(-3, w + 3, (5, 1, h, w)),
                       rng.uniform(-3, h + 3, (5, 1, h, w))], -1)
    return levels, ref, tgt, coords.astype(np.float32)


@pytest.mark.parametrize("method,ofl", [("pallas_q8", -1), ("pallas_q8", 1),
                                        ("pallas", 2), ("pallas", 0),
                                        ("onehot", -1)])
def test_corr_lookup_methods_match_jax(method, ofl, monkeypatch):
    """build_pyramid_for_method + corr_lookup against the JAX package's,
    its Pallas lookups in interpret mode: which levels are quantized, and
    the per-level outputs in both forms."""
    monkeypatch.setattr(jcorr, "_INTERPRET", True)
    levels, ref, tgt, coords = _pyramids(5)
    precision = "bfloat16" if method == "pallas_q8" else "float32"
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if precision == "bfloat16"
               else (torch.float32, jnp.float32))
    t_pyr = tcorr.build_pyramid_for_method(
        torch.from_numpy(ref).to(dt), torch.from_numpy(tgt).to(dt), levels,
        precision, method, ofl)
    j_pyr = jcorr.build_pyramid_for_method(
        jnp.asarray(ref, jdt), jnp.asarray(tgt, jdt), levels, precision,
        method, ofl)
    assert [isinstance(v, tuple) for _, v in t_pyr] == \
        [isinstance(v, tuple) for _, v in j_pyr]
    if method == "pallas_q8":
        assert isinstance(t_pyr[0][1], tuple) == (ofl != 0)
        assert not isinstance(t_pyr[1][1], tuple)  # 9 rows pad to 16
    got = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), 4, method,
                            concat=False, precision=precision,
                            onehot_from_level=ofl)
    want = jcorr.corr_lookup(j_pyr, jnp.asarray(coords), 4, method,
                             precision=precision, concat=False,
                             onehot_from_level=ofl)
    assert len(got) == len(want) == 4
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), lvl
        w = np.asarray(w, np.float32)
        # bf16 volumes: the one bf16 rounding of each side (and the q8
        # rounding above); f32: summation order only
        tol = 2.0 ** -6 if precision == "bfloat16" else 1e-5
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=f"level {lvl}")
    cat = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), 4, method,
                            precision=precision, onehot_from_level=ofl)
    assert tuple(cat.shape) == (1, 18, 8, (5 + 2 * 3) * 81)


def test_quantizes_reads_the_padded_height():
    """The JAX gate tests the row count padded to 16 (corr.py:218)."""
    assert [tcorr.quantizes(h) for h in (60, 30, 17, 16, 15, 7, 32)] == \
        [True, True, True, False, False, False, True]
