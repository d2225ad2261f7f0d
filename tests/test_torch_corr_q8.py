"""Port parity: the int8 volume lookup (lookup_method='pallas_q8'), the
one-hot lookup and the mixed dispatch (onehot_from_level) against the JAX
package: quantize_volume, lookup_level_slab_q8 run in interpret mode,
_lookup_level_onehot and corr_lookup; the level table with int8 levels
(its plain twin, its refusals, and the layout of its ctypes mirror against
csrc/corr_lookup_table.cuh).

Tolerances, stated where they are used:
  * int8 volume: equal, except where v * inv lands on a rounding tie in
    one package and not in the other (XLA may keep the product in f32);
    such elements differ by one and are counted;
  * q8 lookup: the TPU kernel blends the integers in two bf16-rounded
    stages with bf16 hat weights and multiplies by the bf16-rounded scale;
    the port blends in f32 and rounds once, so outputs differ by a few
    bf16 ulps: 2^-6 of max |JAX| (four ulps at the top of the range);
  * one-hot: both select the patch exactly and blend in f32: f32 rtol
    1e-5, atol 1e-5;
  * the mixed table's plain twin against the per-level composition it
    replaces: bit for bit (the same operations in the same order).
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

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
    before = klookup.launches
    out = klookup.corr_lookup_level_q8(q, scale, c, 4)
    assert klookup.launches == before  # the CPU takes the plain version
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


# ---------------------------------------------------------------------------
# int8 levels in the level table (one launch for every pallas_q8 level)


def _q8_table(seed, rest_dtype, h=18, w=8):
    """A level table of the pyramid of _pyramids: level 0 int8 (its row
    scales from quantize_volume), levels 1-3 in rest_dtype, or all four
    int8 (rest_dtype None; level 3's 2x1 maps are not empty); and the
    base coords."""
    levels, ref, tgt, coords = _pyramids(seed, h, w)
    dt = rest_dtype or torch.bfloat16
    pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref).to(dt),
                                   torch.from_numpy(tgt).to(dt), levels,
                                   "bfloat16" if dt == torch.bfloat16
                                   else "float32")
    table = []
    for lvl, (idx, vol) in enumerate(pyr):
        if lvl == 0 or rest_dtype is None:
            q, scale = klookup.quantize_volume(vol)
            table.append(klookup.TableLevel(q, idx, lvl, scale))
        else:
            table.append(klookup.TableLevel(vol, idx, lvl))
    return table, torch.from_numpy(coords)


@pytest.mark.parametrize("rest", [torch.bfloat16, torch.float32, None])
def test_mixed_table_plain_equals_per_level_composition(rest):
    """The all-level twin over int8 and unquantized levels is, bit for
    bit, the per-level composition corr_lookup ran before int8 levels
    joined the table: index and divide, corr_lookup_level_q8_plain or
    corr_lookup_level_plain, permute, and torch.cat (whose promotion is
    the output type: the unquantized levels' type, bf16 for int8 only);
    the wrapper on CPU tensors is the twin and launches nothing."""
    table, c = _q8_table(8, rest)
    h1, w1 = c.shape[2:4]
    old = []
    for lv in table:
        cl = (c[list(lv.targets)] / (2.0 ** lv.level)).reshape(-1, 2)
        maps = lv.vol.reshape(-1, *lv.vol.shape[-2:])
        if lv.scale is None:
            feat = klookup.corr_lookup_level_plain(maps, cl, 4)
        else:
            feat = klookup.corr_lookup_level_q8_plain(maps, lv.scale, cl, 4)
            assert feat.dtype == torch.bfloat16
        old.append(feat.reshape(len(lv.targets), 1, h1, w1, -1)
                   .permute(1, 2, 3, 0, 4).reshape(1, h1, w1, -1))
    old = torch.cat(old, dim=-1)
    assert old.dtype == (rest or torch.bfloat16)
    before = (klookup.launches, klookup.bwd_launches)
    got = klookup.corr_lookup_pyramid_plain(table, c, 4)
    assert got.dtype == old.dtype and torch.equal(got, old)
    assert torch.equal(klookup.corr_lookup_pyramid(table, c, 4), old)
    assert (klookup.launches, klookup.bwd_launches) == before
    assert old.abs().max() > 0


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("ofl", [-1, 1])
def test_corr_lookup_q8_concat_matches_jax(ofl, precision, monkeypatch):
    """corr_lookup(..., 'pallas_q8', concat=True), the int8 level in the
    port's one table launch, against the JAX package's, its Pallas
    lookups in interpret mode. The int8 level's channels within 2^-6 of
    max |JAX| (the module docstring); the others as
    test_corr_lookup_methods_match_jax holds them: bf16 2^-6, f32 1e-5 of
    max(1, max |JAX|)."""
    monkeypatch.setattr(jcorr, "_INTERPRET", True)
    levels, ref, tgt, coords = _pyramids(9)
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if precision == "bfloat16"
               else (torch.float32, jnp.float32))
    t_pyr = tcorr.build_pyramid_for_method(
        torch.from_numpy(ref).to(dt), torch.from_numpy(tgt).to(dt), levels,
        precision, "pallas_q8", ofl)
    j_pyr = jcorr.build_pyramid_for_method(
        jnp.asarray(ref, jdt), jnp.asarray(tgt, jdt), levels, precision,
        "pallas_q8", ofl)
    assert isinstance(t_pyr[0][1], tuple)
    got = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), 4, "pallas_q8",
                            precision=precision, onehot_from_level=ofl)
    want = jcorr.corr_lookup(j_pyr, jnp.asarray(coords), 4, "pallas_q8",
                             precision=precision, onehot_from_level=ofl)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert got.dtype == dt and tuple(got.shape) == (1, 18, 8, 11 * 81)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    off = 0
    for lvl, (idx, vol) in enumerate(t_pyr):
        n = len(idx) * 81
        w = want[..., off:off + n]
        tol = (2.0 ** -6 if isinstance(vol, tuple) or precision == "bfloat16"
               else 1e-5)
        np.testing.assert_allclose(got[..., off:off + n], w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=f"level {lvl}")
        off += n


def test_q8_corr_lookup_builds_one_table(monkeypatch):
    """Under pallas_q8 with no level sent to the one-hot lookup,
    corr_lookup hands the whole pyramid, int8 levels with their scales, to
    one all-level lookup with the base coords themselves (no index or
    divide of its own) and returns that lookup's map as it is (no permute
    or cat); on the CPU nothing launches."""
    levels, ref, tgt, coords = _pyramids(10)
    pyr = tcorr.build_pyramid_for_method(
        torch.from_numpy(ref).bfloat16(), torch.from_numpy(tgt).bfloat16(),
        levels, "bfloat16", "pallas_q8")
    calls = []
    fwd = klookup._pyramid_fwd

    def spy(table, c, radius):
        out = fwd(table, c, radius)
        calls.append((table, c, out))
        return out

    monkeypatch.setattr(klookup, "_pyramid_fwd", spy)
    c = torch.from_numpy(coords)
    before = klookup.launches
    got = tcorr.corr_lookup(pyr, c, 4, "pallas_q8")
    assert klookup.launches == before
    ((table, seen, out),) = calls
    # the base coords' own storage (a detached view), and the map itself
    assert got is out
    assert seen.data_ptr() == c.data_ptr() and seen.shape == c.shape
    assert [lv.level for lv in table] == [0, 1, 2, 3]
    assert [lv.vol.dtype for lv in table] == [torch.int8] + [
        torch.bfloat16] * 3
    assert table[0].scale is pyr[0][1][1] and table[0].vol is pyr[0][1][0]
    assert all(lv.scale is None for lv in table[1:])
    assert got.dtype == torch.bfloat16


def _bad_table(fault):
    table, c = _q8_table(11, torch.bfloat16)
    q = table[0]
    if fault == "no_scale":
        table[0] = q._replace(scale=None)
    elif fault == "scale_shape":
        table[0] = q._replace(scale=q.scale.reshape(-1))
    elif fault == "scale_type":
        table[0] = q._replace(scale=q.scale.double())
    elif fault == "scale_strided":
        table[0] = q._replace(scale=q.scale.transpose(0, 2).contiguous()
                              .transpose(0, 2))
    elif fault == "scale_on_bf16":
        table[1] = table[1]._replace(scale=q.scale)
    elif fault == "mixed_unquantized":
        table[2] = table[2]._replace(vol=table[2].vol.float())
    elif fault == "empty_int8_map":
        table[0] = q._replace(vol=q.vol[..., :0, :])
    return table, c


@pytest.mark.parametrize("fault,exc", [
    ("no_scale", ValueError), ("scale_shape", ValueError),
    ("scale_type", TypeError), ("scale_strided", ValueError),
    ("scale_on_bf16", ValueError), ("mixed_unquantized", TypeError),
    ("empty_int8_map", ValueError)])
def test_table_refuses_bad_int8_levels(fault, exc):
    """What the kernel cannot take raises before any pointer is handed
    over, on the CPU path as on the card's."""
    table, c = _bad_table(fault)
    with pytest.raises(exc):
        klookup.corr_lookup_pyramid(table, c, 4)


def test_int8_table_has_no_backward():
    """A table with an int8 level: the backward wrappers raise before any
    launch, and autograd through it raises 'inference only', in the
    wrapper and in corr_lookup."""
    table, c = _q8_table(12, torch.float32)
    g = torch.zeros(1, 18, 8, 11 * 81)
    before = klookup.bwd_launches
    with pytest.raises(ValueError, match="no backward"):
        klookup.lookup_pyramid_bwd_cuda(table, c, g, 4, None)
    with pytest.raises(ValueError, match="no backward"):
        klookup.corr_lookup_pyramid_bwd_plain(table, c, g, 4, None)
    assert klookup.bwd_launches == before
    with pytest.raises(RuntimeError, match="inference only"):
        klookup.corr_lookup_pyramid(table, c.clone().requires_grad_(True), 4)
    with pytest.raises(RuntimeError, match="inference only"):
        klookup.corr_lookup_pyramid(
            [table[0]._replace(scale=table[0].scale.requires_grad_(True))],
            c, 4)
    pyr = [(lv.targets, (lv.vol, lv.scale) if lv.scale is not None
            else lv.vol.requires_grad_(True)) for lv in table]
    with pytest.raises(RuntimeError, match="inference only"):
        tcorr.corr_lookup(pyr, c, 4, "pallas_q8")
    with torch.no_grad():  # inference: the same map as the twin
        assert torch.equal(tcorr.corr_lookup(pyr, c, 4, "pallas_q8"),
                           klookup.corr_lookup_pyramid_plain(table, c, 4))


_TABLE_HEADER = (Path(__file__).resolve().parent.parent / "bflow_tpu_torch"
                 / "csrc" / "corr_lookup_table.cuh")


@pytest.mark.parametrize("struct", ["LevelDesc", "LookupTable"])
def test_table_mirror_layout_matches_header(struct):
    """The ctypes mirror has the size and field offsets that the header's
    static_asserts hold the CUDA struct to (a mismatch gives wrong numbers
    on the card, not a crash), and every field the mirror names is
    asserted there."""
    text = _TABLE_HEADER.read_text()
    (size,) = re.findall(
        rf"static_assert\(sizeof\({struct}\) == (\d+)", text)
    offsets = dict(re.findall(
        rf"static_assert\(offsetof\({struct}, (\w+)\) ==\s*(\d+)", text))
    mirror = {"LevelDesc": klookup._LevelDesc,
              "LookupTable": klookup._LookupTable}[struct]
    assert ctypes.sizeof(mirror) == int(size)
    assert offsets and set(offsets) <= {f for f, _ in mirror._fields_}
    for field, off in offsets.items():
        assert getattr(mirror, field).offset == int(off), field
    named = {f for f, _ in mirror._fields_} - set(offsets)
    assert named <= {"level", "pad"}, named
