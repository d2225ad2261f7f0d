"""Port parity of the all-level correlation lookup and its accumulating
backward: the plain twins of the CUDA kernels (corr_lookup_pyramid_plain,
corr_lookup_pyramid_bwd_plain) and the autograd plumbing that sends every
iteration's dVol into one buffer per level (VolumeSink), on the CPU.

Bounds, each with its reason:
  * the all-level forward against the JAX package's corr_lookup: f32
    1e-5 of max(1, max |ref|) against the gather (the same blend; XLA may
    reassociate), bf16 2^-6 of it (one bf16 rounding on each side, JAX
    rounding inside its blend); against the Pallas kernel in interpret
    mode f32 rtol 1e-4 / atol 1e-5 (hat-weight matmuls sum in another
    order, tests/test_torch_corr.py);
  * the twin against the composition of the per-level plain lookups, the
    accumulating backward against the per-iteration VJPs summed in
    backward order, and the fused convc1 on the concatenated map against
    the per-level cat: bit for bit (the same operations in the same
    order);
  * base dcoords against autograd through the index and divide: 1e-6 of
    max |ref| (autograd sums a target's levels in its own order);
  * the sink's gradients against the gather path's (plain autograd,
    summing the iterations' dVols in the engine's order): f32 1e-6 of
    max |ref|; against the JAX package: tests/test_torch_train.py's.

Coordinates include points at +-1e4 and -300, 450, and base coordinates
just below multiples of 8, which stay just below an integer at every
level, where x + dx can round up onto an integer (the kernels' rounding
edge).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu.models import corr as jcorr
from bflow_tpu_torch.kernels import corr_lookup as klookup
from bflow_tpu_torch.models import corr as tcorr
from bflow_tpu_torch.models.update import BasicMotionEncoder
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_common import configs, rel_err

LEVELS = (1, 1, 1, 4, 4)
R = 4
WIN2 = (2 * R + 1) ** 2
# query grids (h, w): level maps 8x8 .. 1x1, and 10x14 .. 1x1 (odd pools)
GRIDS = [(8, 8), (10, 14)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, h, w, T=5, D=16, edge=True):
    """Features (T, 1, h, w, D) and base coords (T, 1, h, w, 2): uniform
    around the map, one in five far, and (edge) one in five just below a
    multiple of 8."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((T, 1, h, w, D)).astype(np.float32)
    tgt = rng.standard_normal((T, 1, h, w, D)).astype(np.float32)
    shape = (T, 1, h, w)
    coords = np.stack([rng.uniform(-4, w + 3, shape),
                       rng.uniform(-4, h + 3, shape)], -1).astype(np.float32)
    pick = rng.random(shape)
    far = pick < 0.2
    coords[far] = rng.choice([-1e4, 1e4, -300.0, 450.0], size=(far.sum(), 2))
    below = pick > (0.8 if edge else 1.0)
    k = rng.choice([0.0, 8.0, 16.0], size=(below.sum(), 2)).astype(np.float32)
    coords[below] = np.nextafter(k, np.float32(-np.inf))
    return ref, tgt, coords


def _pyramids(seed, h, w, dtype="float32"):
    tdt, jdt = DTYPES[dtype]
    ref, tgt, coords = _inputs(seed, h, w)
    t_pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref).to(tdt),
                                     torch.from_numpy(tgt).to(tdt), LEVELS,
                                     dtype)
    j_pyr = jcorr.build_corr_pyramid(jnp.asarray(ref, jdt),
                                     jnp.asarray(tgt, jdt), LEVELS, dtype)
    return t_pyr, j_pyr, coords


def _table(pyramid):
    return [klookup.TableLevel(vol, idx, lvl)
            for lvl, (idx, vol) in enumerate(pyramid)]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("concat", [True, False])
def test_pyramid_lookup_matches_jax_gather(grid, dtype, concat):
    """corr_lookup through the all-level lookup (its plain twin on the
    CPU) against the JAX package's gather lookup, both output forms."""
    t_pyr, j_pyr, coords = _pyramids(0, *grid, dtype)
    got = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), R, "pallas",
                            concat=concat)
    want = jcorr.corr_lookup(j_pyr, jnp.asarray(coords), R, "gather",
                             concat=concat)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    if concat:
        assert got.dtype == DTYPES[dtype][0]
        assert tuple(got.shape) == (1, *grid, (5 + 2 * 3) * WIN2)
        _close(got, want, tol)
        return
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g, w, tol)


def test_pyramid_lookup_matches_pallas_interpret(monkeypatch):
    """One small case against the JAX Pallas lookup in interpret mode,
    both output forms."""
    monkeypatch.setattr(jcorr, "_INTERPRET", True)
    ref, tgt, coords = _inputs(1, 8, 8)
    t_pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref),
                                     torch.from_numpy(tgt), LEVELS)
    j_pyr = jcorr.build_pyramid_for_method(jnp.asarray(ref), jnp.asarray(tgt),
                                           LEVELS, "float32", "pallas")
    want = jcorr.corr_lookup(j_pyr, jnp.asarray(coords), R, "pallas",
                             concat=False)
    got = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), R, "pallas",
                            concat=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    cat = tcorr.corr_lookup(t_pyr, torch.from_numpy(coords), R, "pallas")
    assert torch.equal(cat, torch.cat(
        [g.permute(1, 2, 3, 0, 4).reshape(1, 8, 8, -1) for g in got], -1))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pyramid_plain_equals_per_level_composition(grid, dtype):
    """The twin is the per-level composition the port ran before (index,
    divide, one-level lookup, permute, cat), bit for bit; the wrapper on
    CPU tensors is the twin, and launches nothing."""
    t_pyr, _, coords = _pyramids(2, *grid, dtype)
    c = torch.from_numpy(coords)
    h1, w1 = grid
    old = []
    for lvl, (idx, vol) in enumerate(t_pyr):
        cl = c[list(idx)] / (2.0 ** lvl)
        q = len(idx) * h1 * w1
        feat = klookup.corr_lookup_level_plain(
            vol.reshape(q, *vol.shape[-2:]), cl.reshape(q, 2), R)
        old.append(feat.reshape(len(idx), 1, h1, w1, -1)
                   .permute(1, 2, 3, 0, 4).reshape(1, h1, w1, -1))
    old = torch.cat(old, dim=-1)
    before = (klookup.launches, klookup.bwd_launches)
    got = klookup.corr_lookup_pyramid_plain(_table(t_pyr), c, R)
    assert got.dtype == DTYPES[dtype][0]
    assert torch.equal(got, old)
    assert torch.equal(klookup.corr_lookup_pyramid(_table(t_pyr), c, R), old)
    assert (klookup.launches, klookup.bwd_launches) == before


def _pyramid_list_indexed(fmap_ref, fmap_tgt, levels, precision):
    """build_corr_pyramid with each level's targets picked by indexing
    with Python lists (an index tensor, which CUDA copies and waits for):
    the formulation that build_corr_pyramid's slices and stacks must
    reproduce."""
    per_level = tcorr.level_target_indices(levels)
    out = [(per_level[0],
            tcorr.all_pairs_correlation(fmap_ref, fmap_tgt, precision))]
    prev_idx, prev_tgt = per_level[0], fmap_tgt
    for idx in per_level[1:]:
        sel = [prev_idx.index(i) for i in idx]
        tgt = tcorr._avg_pool_2x2(prev_tgt[sel])
        out.append((idx, tcorr.all_pairs_correlation(
            fmap_ref[list(idx)], tgt, precision)))
        prev_idx, prev_tgt = idx, tgt
    return out


@pytest.mark.parametrize("levels", [(1, 1, 1, 4, 4), (1, 1, 1, 1, 4, 4),
                                    (4, 1, 4, 1)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pyramid_equals_list_indexed_build(levels, dtype):
    """The released DSEC (3, 4) and MultiFlow (4, 5) level targets, and a
    non-contiguous list: every level's targets and volume equal the
    list-indexed build's bit for bit, on features laid out as the model
    stacks them (feature axis permuted last), and so do the features'
    gradients through every level."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(len(levels))
    T, N, D, h, w = len(levels), 2, 16, 10, 14

    def features():
        x = rng.standard_normal((T, N, D, h, w)).astype(np.float32)
        return torch.from_numpy(x).to(tdt).permute(0, 1, 3, 4, 2)

    ref, tgt = features(), features()
    grads = {}
    for name, build in (("slices", tcorr.build_corr_pyramid),
                        ("lists", _pyramid_list_indexed)):
        r, t = (x.detach().requires_grad_() for x in (ref, tgt))
        pyr = build(r, t, levels, dtype)
        grads[name] = pyr, torch.autograd.grad(
            sum((vol.float() * (lvl + 1)).sum()
                for lvl, (_, vol) in enumerate(pyr)), (r, t))
    (got, got_g), (want, want_g) = grads["slices"], grads["lists"]
    assert len(got) == len(want) == max(levels)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi == wi
        assert gv.dtype == wv.dtype and torch.equal(gv, wv)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


@pytest.mark.parametrize("idx", [(3, 4), (2,), (0, 1, 2, 3, 4), (4, 1, 4, 1),
                                 (1, 3), (4, 3)])
def test_take_targets_gives_indexing_values_and_strides(idx):
    """The pyramid's pick of targets equals x[list(idx)] in values and in
    strides, on the model's permuted layout and on a contiguous one."""
    base = torch.arange(5 * 2 * 3 * 4 * 6, dtype=torch.float32)
    for x in (base.reshape(5, 2, 3, 4, 6).permute(0, 1, 3, 4, 2),
              base.reshape(5, 2, 4, 6, 3)):
        got, want = tcorr._take_targets(x, idx), x[list(idx)]
        assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pyramid_bwd_plain_accumulates_in_backward_order(dtype):
    """Three iterations' cotangents into one accumulator equal, bit for
    bit, the per-iteration VJPs (rounded to the volume's type) summed in
    f32 in backward order, last iteration first; dcoords per iteration
    equal the per-level VJPs scaled by 2^-l and summed in level order."""
    t_pyr, _, coords = _pyramids(3, 10, 14, dtype)
    tdt = DTYPES[dtype][0]
    table = _table(t_pyr)
    rng = np.random.default_rng(4)
    C = 11 * WIN2
    gs = [torch.from_numpy(rng.standard_normal((1, 10, 14, C)).astype(
        np.float32)).to(tdt) for _ in range(3)]
    c = torch.from_numpy(coords)
    acc = [torch.zeros(lv.vol.shape) for lv in table]
    dcs = [klookup.corr_lookup_pyramid_bwd_plain(table, c, g, R, acc)
           for g in reversed(gs)]
    for i, lv in enumerate(table):
        want = torch.zeros(lv.vol.shape)
        off = sum(len(t.targets) for t in table[:i]) * WIN2
        tl = len(lv.targets)
        maps = klookup._level_maps(lv)
        cl = (c[list(lv.targets)] / (2.0 ** lv.level)).reshape(-1, 2)
        for g in reversed(gs):
            gl = g[..., off:off + tl * WIN2].reshape(1, 10, 14, tl, WIN2)
            dv, _ = klookup.corr_lookup_level_bwd_plain(
                maps, cl, gl.permute(3, 0, 1, 2, 4).reshape(-1, WIN2), R)
            assert dv.dtype == tdt
            want = want + dv.reshape(lv.vol.shape).float()
        assert torch.equal(acc[i], want), i
        assert want.abs().max() > 0 or lv.vol.shape[-1] == 0
    # dcoords: each target's levels in order
    for g, dc in zip(reversed(gs), dcs):
        want = torch.zeros_like(c)
        off = 0
        for lv in table:
            tl = len(lv.targets)
            gl = g[..., off:off + tl * WIN2].reshape(1, 10, 14, tl, WIN2)
            off += tl * WIN2
            _, d = klookup.corr_lookup_level_bwd_plain(
                klookup._level_maps(lv),
                (c[list(lv.targets)] / (2.0 ** lv.level)).reshape(-1, 2),
                gl.permute(3, 0, 1, 2, 4).reshape(-1, WIN2), R)
            want[list(lv.targets)] += d.reshape(tl, 1, 10, 14, 2) / (
                2.0 ** lv.level)
        assert torch.equal(dc, want)


def test_pyramid_bwd_plain_dcoords_match_autograd():
    """Base dcoords against autograd through the index, the divide and the
    per-level gather lookups (the composition the JAX package runs)."""
    t_pyr, _, coords = _pyramids(5, 8, 8)
    table = _table(t_pyr)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 8, 8, 11 * WIN2)).astype(np.float32))
    c = torch.from_numpy(coords).requires_grad_(True)
    out = klookup.corr_lookup_pyramid_plain(table, c, R)
    (want,) = torch.autograd.grad(out, c, g)
    got = klookup.corr_lookup_pyramid_bwd_plain(table, c.detach(), g, R, None)
    assert want.abs().max() > 0
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert klookup.corr_lookup_pyramid_bwd_plain(table, c.detach(), g, R,
                                                 None, False) is None


# ---------------------------------------------------------------------------
# the sink: one dVol buffer per level for a whole backward pass


def _looped(method, iters=3, seed=7, onehot_from_level=-1, edge=True):
    """A pyramid of features that need gradients, and `iters` lookups of
    it at coords that depend on a leaf, summed into a loss."""
    ref, tgt, coords = _inputs(seed, 8, 8, edge=edge)
    fmaps = (torch.from_numpy(ref).requires_grad_(True),
             torch.from_numpy(tgt).requires_grad_(True))
    base = torch.from_numpy(coords).requires_grad_(True)
    pyr = tcorr.build_corr_pyramid(*fmaps, LEVELS)
    rng = np.random.default_rng(seed + 1)
    loss = 0.0
    for i in range(iters):
        c = base * (1.0 + 0.1 * i)
        out = tcorr.corr_lookup(pyr, c, R, method,
                                onehot_from_level=onehot_from_level)
        w = torch.from_numpy(rng.standard_normal(out.shape).astype(
            np.float32))
        loss = loss + (out * w).sum()
    return loss, (*fmaps, base), pyr


@pytest.mark.parametrize("onehot_from_level", [-1, 2])
def test_sink_gradients_match_gather_path(onehot_from_level):
    """Three iterations through the sink (the kernel path's structure)
    against plain autograd through the gather lookups. With
    onehot_from_level=2 the sink serves levels 0-1 and reads its slice of
    the cotangent of the concatenated map; levels 2-3 take the one-hot
    matmuls (f32: 1e-5, their sums run in another order; no coordinate
    sits at the rounding edge, where the one-hot form, which floors x
    once per query, takes the other one-sided derivative)."""
    edge = onehot_from_level == -1
    loss, leaves, pyr = _looped("pallas", edge=edge,
                                onehot_from_level=onehot_from_level)
    got = torch.autograd.grad(loss, leaves)
    assert len(pyr.sink._acc.vols) == (2 if onehot_from_level == 2 else 4)
    loss_g, leaves_g, _ = _looped("gather", edge=edge)
    want = torch.autograd.grad(loss_g, leaves_g)
    tol = 1e-6 if onehot_from_level == -1 else 1e-5
    np.testing.assert_allclose(loss.item(), loss_g.item(), rtol=tol)
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        assert (g - w).abs().max() <= tol * w.abs().max()


def test_sink_equals_gather_path_exactly_in_f32():
    """The accumulated dVol equals the sum autograd forms on the gather
    path, bit for bit: per iteration the f32 VJP, summed in the order the
    engine runs the iterations (last first)."""
    def vol_grads(method):
        ref, tgt, coords = _inputs(8, 8, 8)
        pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref),
                                       torch.from_numpy(tgt), LEVELS)
        vols = [v.detach().requires_grad_(True) for _, v in pyr]
        pyr = tcorr.CorrPyramid([(i, v) for (i, _), v in zip(pyr, vols)])
        rng = np.random.default_rng(9)
        loss = 0.0
        for i in range(3):
            c = torch.from_numpy(coords) * (1.0 + 0.1 * i)
            out = tcorr.corr_lookup(pyr, c, R, method)
            loss = loss + (out * torch.from_numpy(rng.standard_normal(
                out.shape).astype(np.float32))).sum()
        return torch.autograd.grad(loss, vols)

    for g, w in zip(vol_grads("pallas"), vol_grads("gather")):
        assert torch.equal(g, w)


def test_sink_retain_graph_twice_gives_equal_gradients():
    loss, leaves, pyr = _looped("pallas")
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    assert pyr.sink._acc._bufs is None  # handed out and dropped
    second = torch.autograd.grad(loss, leaves)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_coords_only_grad_allocates_no_accumulator(monkeypatch):
    """A torch.autograd.grad that asks for the coords only never runs the
    sink, so no lookup allocates or keeps an accumulator; the coords'
    gradient equals the one of a full backward."""
    loss, (ref, tgt, base), pyr = _looped("pallas")
    made = []
    real = klookup._Accumulators.buffers

    def spy(self, node):
        bufs = real(self, node)
        made.append(bufs)
        return bufs

    monkeypatch.setattr(klookup._Accumulators, "buffers", spy)
    (dc,) = torch.autograd.grad(loss, base, retain_graph=True)
    assert made == [None, None, None] and pyr.sink._acc._bufs is None
    made.clear()
    _, _, dc_all = torch.autograd.grad(loss, (ref, tgt, base))
    assert len(made) == 3 and made[0] is made[1] is made[2]
    assert torch.equal(dc, dc_all)


def test_no_sink_without_volume_gradients():
    """Volumes that need no gradient: no sink node, coords still get
    theirs; under no_grad no autograd node at all."""
    ref, tgt, coords = _inputs(10, 8, 8)
    pyr = tcorr.build_corr_pyramid(torch.from_numpy(ref),
                                   torch.from_numpy(tgt), LEVELS)
    c = torch.from_numpy(coords).requires_grad_(True)
    out = tcorr.corr_lookup(pyr, c, R, "pallas")
    assert pyr.sink._token is None and out.grad_fn is not None
    (dc,) = torch.autograd.grad(out.sum(), c)
    want = klookup.corr_lookup_pyramid_bwd_plain(
        _table(pyr), c.detach(), torch.ones_like(out), R, None)
    assert torch.equal(dc, want)
    with torch.no_grad():
        assert tcorr.corr_lookup(pyr, c, R, "pallas").grad_fn is None


def test_sink_refuses_other_volumes_and_missing_sink():
    """The kernel path under autograd needs the pyramid's sink: a plain
    list of volumes that need gradients is refused (the gather path and a
    plain list without volume gradients still run), as is a sink asked to
    serve volumes other than those of its first call."""
    ref, tgt, coords = _inputs(14, 8, 8)
    fmaps = [torch.from_numpy(a).requires_grad_(True) for a in (ref, tgt)]
    pyr = tcorr.build_corr_pyramid(*fmaps, LEVELS)
    c = torch.from_numpy(coords)
    with pytest.raises(ValueError, match="VolumeSink"):
        tcorr.corr_lookup(list(pyr), c, R, "pallas")
    assert tcorr.corr_lookup(list(pyr), c, R, "gather").grad_fn is not None
    detached = [(idx, vol.detach()) for idx, vol in pyr]
    assert torch.equal(tcorr.corr_lookup(detached, c, R, "pallas"),
                       tcorr.corr_lookup(pyr, c, R, "pallas").detach())
    with pytest.raises(ValueError, match="VolumeSink"):
        klookup.corr_lookup_pyramid(_table(pyr), c, R)
    with pytest.raises(ValueError, match="other volumes"):
        klookup.corr_lookup_pyramid(_table(pyr)[:2], c, R, pyr.sink)
    with pytest.raises(ValueError, match="other volumes"):
        tcorr.corr_lookup(pyr, c, R, "pallas", onehot_from_level=2)


@pytest.mark.parametrize("levels", [slice(None), slice(1, None)])
def test_chip_smoke_lookup_bounds_count_coords_once_per_target(levels):
    """chip_smoke's all-level bounds against a count cell by cell: per
    (level, target) slot the in-map cells of each query's (2r+2)^2 patch
    (read from vol; and in the backward from the f32 accumulator, read and
    written) and its 81 taps (written; in the backward the cotangents,
    read); the base coords read once per target the table names, and in
    the backward dcoords written once per base target."""
    import chip_smoke

    table, coords = chip_smoke.pyramid_inputs(1, 6, 10, torch.float32, 15,
                                              device="cpu")
    table = table[levels]
    cells = taps = 0
    for lv in table:
        maps, cl = klookup._level_maps(lv), klookup._level_coords(coords, lv)
        hl, wl = maps.shape[1:]
        for x, y in np.floor(cl.numpy()).astype(np.int64):
            rows = [r for r in range(y - R, y + R + 2) if 0 <= r < hl]
            cols = [q for q in range(x - R, x + R + 2) if 0 <= q < wl]
            cells += len(rows) * len(cols)
        taps += maps.shape[0] * WIN2
    M = 6 * 10
    named = len({t for lv in table for t in lv.targets})
    assert named == (5 if levels.start is None else 2)
    assert cells > 0
    assert chip_smoke.pyramid_bound_bytes(table, coords, R) == (
        4 * cells + 4 * taps + 8 * M * named)
    assert chip_smoke.pyramid_bwd_bound_bytes(table, coords, R) == (
        12 * cells + 4 * taps + 8 * M * named + 8 * M * 5)


@pytest.mark.parametrize("levels", [slice(None), slice(0, 2)])
def test_chip_smoke_q8_bounds_count_each_level_type(levels):
    """chip_smoke's forward bound over pallas_q8's tables (int8 levels
    beside bf16 ones, and the int8 levels alone) against a count cell by
    cell: per (level, target) slot the in-map cells of each query's
    (2r+2)^2 patch in the level's type (1 byte int8, 2 bf16) and its 81
    taps in the output type (bf16), each int8 level's f32 row scales once,
    the base coords once per target the table names."""
    import chip_smoke

    # 34 query rows: levels 0 and 1 (34 and 17 rows) quantize
    table, coords = chip_smoke.pyramid_inputs(1, 34, 4, torch.bfloat16, 16,
                                              device="cpu")
    table = chip_smoke.q8_table(table)[levels]
    assert [lv.vol.dtype for lv in table][:2] == [torch.int8] * 2
    cells = {torch.int8: 0, torch.bfloat16: 0}
    taps = rows = 0
    for lv in table:
        maps, cl = klookup._level_maps(lv), klookup._level_coords(coords, lv)
        hl, wl = maps.shape[1:]
        for x, y in np.floor(cl.numpy()).astype(np.int64):
            r_in = [r for r in range(y - R, y + R + 2) if 0 <= r < hl]
            c_in = [q for q in range(x - R, x + R + 2) if 0 <= q < wl]
            cells[lv.vol.dtype] += len(r_in) * len(c_in)
        taps += maps.shape[0] * WIN2
        rows += 0 if lv.scale is None else len(lv.targets) * 34
    M = 34 * 4
    named = len({t for lv in table for t in lv.targets})
    assert cells[torch.int8] > 0 and rows == 7 * 34
    assert chip_smoke.pyramid_bound_bytes(table, coords, R) == (
        cells[torch.int8] + 2 * cells[torch.bfloat16] + 2 * taps + 4 * rows
        + 8 * M * named)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_convc1_on_concat_map_equals_per_level_cat(dtype):
    """With fuse_corr_conv the motion encoder reads the lookup's
    concatenated map as convc1's input matrix: bit for bit the per-level
    cat it formed before; without it, the concat form."""
    cdt = {"compute_dtype": dtype, "corr_precision": dtype}
    _, cfg = configs(fuse_corr_conv=True, **cdt)
    enc = BasicMotionEncoder(cfg)
    gen = torch.Generator().manual_seed(11)
    for p in enc.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1
    t_pyr, _, coords = _pyramids(12, 8, 8, dtype)
    c = torch.from_numpy(coords)
    per_level = tcorr.corr_lookup(t_pyr, c, R, "pallas", concat=False)
    cat_map = tcorr.corr_lookup(t_pyr, c, R, "pallas")
    with torch.no_grad():
        got = enc._corr_features(cat_map)
        want = enc._corr_features(per_level)
        enc.fuse = False
        concat_form = enc._corr_features(cat_map)
    assert torch.equal(got, want)
    assert concat_form.dtype == got.dtype
    assert rel_err(concat_form.float().numpy(), got.float().numpy()) < (
        1e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# the model: a train step through the sink against the JAX package


@pytest.fixture(scope="module")
def dsec_jax_run():
    from test_torch_train import _run_jax

    return _run_jax("dsec", seed=0)


def _port_grads(variables, batch, **overrides):
    """Loss and gradients of one train-mode forward/backward through the
    lookup kernels' structure (their twins on the CPU)."""
    from test_torch_train import _port_model, _torch_batch

    from bflow_tpu_torch.utils import losses as tlosses

    model = _port_model("dsec", variables, lookup_method="pallas",
                        **overrides).train()
    tb = _torch_batch(batch)
    preds = model(tb["ev_repr"], tb.get("img"), test_mode=False)
    loss = tlosses.l1_seq_loss_masked([p.flow_at(1.0) for p in preds],
                                      tb["flow"], tb["flow_valid"])
    params = dict(model.named_parameters())
    return loss, params


def _flax_grads(grads, model_sd):
    from test_torch_train import _as_flax, _flat

    sd = {**model_sd, **grads}
    return _flat(_as_flax(sd)["params"])


def test_train_step_through_sink_matches_jax(dsec_jax_run):
    """One DSEC train-mode forward/backward with lookup_method='pallas'
    (the sink, the accumulating twin) against the JAX package's step
    gradients, at tests/test_torch_train.py's bounds; a second backward
    of the retained graph gives the same gradients."""
    variables, batch, want = dsec_jax_run
    loss, params = _port_grads(variables, batch)
    names = list(params)
    g1 = torch.autograd.grad(loss, [params[k] for k in names],
                             retain_graph=True, allow_unused=True)
    g2 = torch.autograd.grad(loss, [params[k] for k in names],
                             allow_unused=True)
    for a, b in zip(g1, g2):
        assert (a is None and b is None) or torch.equal(a, b)
    np.testing.assert_allclose(loss.item(), float(want["loss"]), rtol=1e-5)
    grads = {k: (torch.zeros_like(params[k]) if g is None else g)
             for k, g in zip(names, g1)}
    from test_torch_train import _port_model

    sd = {k: v.clone() for k, v in _port_model(
        "dsec", variables).state_dict().items()}
    got = _flax_grads(grads, sd)
    from test_torch_train import _flat

    want_g = _flat(want["grads"])
    gmax = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        bound = 1e-3 * max(np.abs(w).max(), 1e-3 * gmax)
        assert np.abs(got[k] - w).max() <= bound, k


def test_train_remat_through_sink_gives_same_gradients(dsec_jax_run):
    """remat_updates recomputes the update blocks in the backward pass,
    not the lookups: the same gradients as without it."""
    variables, batch, _ = dsec_jax_run
    out = {}
    for remat in (False, True):
        loss, params = _port_grads(variables, batch, remat_updates=remat)
        loss.backward()
        out[remat] = {k: p.grad for k, p in params.items()}
    for k, g in out[False].items():
        assert torch.equal(out[True][k], g), k


def test_model_train_step_on_cpu_launches_nothing():
    """The CPU train-mode forward and backward run the twins through the
    sink: gradients reach every encoder, and no kernel launches."""
    _, cfg = configs(lookup_method="pallas")
    model = bt.build_model(dataclasses.replace(cfg, iters_train=1),
                           device="cpu").train()
    rng = np.random.default_rng(13)
    voxel = torch.from_numpy(rng.standard_normal(
        (1, 32, 32, cfg.nbins_total)).astype(np.float32))
    images = torch.from_numpy(rng.integers(0, 255, (2, 1, 32, 32, 3)).astype(
        np.float32))
    before = (klookup.launches, klookup.bwd_launches)
    preds = model(voxel, images, test_mode=False)
    preds[-1].params.sum().backward()
    assert (klookup.launches, klookup.bwd_launches) == before
    for name in ("fnet_ev.conv2.weight", "fnet_img.conv2.weight"):
        assert dict(model.named_parameters())[name].grad.abs().max() > 0
