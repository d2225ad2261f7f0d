"""Port parity: the two convolution kernels' plain versions, gates and
gradients against the JAX package's Pallas conv kernels (run in interpret
mode on the CPU) and their custom VJPs.

Tolerances:
  * forward: the port's plain version and the Pallas kernel compute the
    same function (bf16 operands, f32 sums, f32 bias, one rounding to
    bf16) and differ only in the order of the f32 sums, so an element can
    round to the neighbouring bf16 value: one bf16 ulp, 2^-7 relative to
    the element and 2^-8 of the largest output absolute;
  * gradients: both take the gradient of the same bf16 conv with the
    cotangent rounded to bf16 (torch's conv gradient against XLA's), bf16
    results whose sums differ in order: 2^-6 of the largest gradient for
    x and the kernel. The bias gradient is the sum of the bf16 cotangent:
    XLA on the CPU accumulates it in bf16 (2.2e-2 of its max from the
    exact sum over 128 pixels), torch in f32 with one rounding; so the
    port's is held to the exact sum at 2^-7 and to JAX's at 5e-2.

Around the kernels (no tolerance: exact): the wrappers give the same bits
for any layout of x and return channels-last memory, the prepared-weight
cache never serves a stale value, and the tile plan is one the kernels are
built for.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
import chip_smoke

from bflow_tpu.ops.pallas import conv3x3 as jconv
from bflow_tpu.ops.pallas import stem_conv as jstem
from bflow_tpu_torch.kernels import conv3x3 as kconv
from bflow_tpu_torch.kernels import conv_common
from bflow_tpu_torch.kernels import stem_conv as kstem
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ULP = 2.0 ** -7


def _case(seed, shape, o, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.1 * rng.standard_normal((kh, kw, shape[-1], o))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(o)).astype(np.float32)
    return x, k, b


def _to_port(x, k, b):
    """NHWC x, HWIO kernel -> the port's NCHW bf16 x and OIHW weight."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return xt.bfloat16(), wt, torch.from_numpy(b)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _assert_one_ulp(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=ULP,
                               atol=ULP / 2 * np.abs(want).max())


# tests/test_conv3x3.py shapes, plus the fused ReLU
CONV_CASES = [((2, 16, 32, 64), 64, 3, 3, False),
              ((1, 12, 24, 96), 96, 3, 3, False),
              ((1, 8, 16, 128), 128, 3, 3, False),
              ((1, 10, 40, 15), 64, 3, 3, False),
              ((1, 12, 16, 384), 384, 1, 5, False),
              ((1, 12, 16, 384), 384, 5, 1, False),
              ((1, 8, 16, 4), 128, 7, 7, False),
              ((1, 12, 62, 64), 64, 3, 3, False),
              ((1, 12, 20, 256), 192, 3, 3, True)]


@pytest.mark.parametrize("shape,o,kh,kw,relu", CONV_CASES)
def test_conv3x3_plain_matches_pallas_interpret(shape, o, kh, kw, relu):
    x, k, b = _case(0, shape, o, kh, kw)
    assert jconv.supported(shape, jnp.bfloat16, o, kh, kw)
    want = jconv.conv2d_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                               jnp.asarray(b), True, relu)
    got = kconv.conv2d_plain(*_to_port(x, k, b), relu)
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], o, shape[1], shape[2])
    _assert_one_ulp(_nhwc(got), want)
    if relu:
        assert (got >= 0).all()


# tests/test_stem_conv.py shapes
STEM_CASES = [((2, 32, 64, 15), 64, 7), ((1, 24, 48, 3), 64, 7),
              ((1, 32, 32, 18), 64, 7), ((2, 24, 32, 64), 96, 3),
              ((1, 16, 24, 96), 128, 3), ((1, 12, 28, 64), 96, 3)]


@pytest.mark.parametrize("shape,o,kh", STEM_CASES)
def test_stem_plain_matches_pallas_interpret(shape, o, kh):
    x, k, b = _case(1, shape, o, kh, kh)
    assert jstem.supported(shape, jnp.bfloat16, kh, kh)
    want = jstem.stem_conv_pallas(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(k), jnp.asarray(b), True)
    got = kstem.stem_conv_plain(*_to_port(x, k, b))
    n, h, w, _ = shape
    assert got.dtype == torch.bfloat16 and got.shape == (n, o, h // 2, w // 2)
    _assert_one_ulp(_nhwc(got), want)


def _conv_shapes():
    """A grid of (NHWC shape, out features, kh, kw) around the gates'
    edges, with the flagship update-block and encoder shapes."""
    out = []
    for h, w in ((60, 80), (30, 40), (17, 8), (36, 48), (240, 320), (9, 62)):
        for c in (4, 64, 128, 256, 384):
            for o in (4, 64, 192, 384, None):
                for kh, kw in ((3, 3), (1, 5), (5, 1), (7, 7), (5, 5)):
                    out.append(((1, h, w, c), o, kh, kw))
    return out


def test_conv3x3_gate_equals_jax():
    dtypes = ((torch.bfloat16, jnp.bfloat16), (None, None),
              (torch.float32, jnp.float32))
    n = 0
    for shape, o, kh, kw in _conv_shapes():
        for tdt, jdt in dtypes:
            assert kconv.supported(shape, tdt, o, kh, kw) == \
                jconv.supported(shape, jdt, o, kh, kw), (shape, o, kh, kw, tdt)
            n += 1
    assert n > 1000
    # the flagship GRU gate convs at 60x80: the fused 1x5 fails the
    # working-set budget (8,045,696 B), the fused 5x1 passes
    assert not kconv.supported((1, 60, 80, 384), torch.bfloat16, 384, 1, 5)
    assert kconv.supported((1, 60, 80, 384), torch.bfloat16, 384, 5, 1)
    # bezier_head.conv2's 4 outputs fail the fan-out rule
    assert not kconv.supported((1, 60, 80, 256), torch.bfloat16, 4)


def test_stem_gate_equals_jax():
    n = 0
    for h, w in ((480, 640), (240, 320), (120, 160), (33, 64), (32, 64),
                 (144, 64), (36, 16), (34, 18)):
        for c in (3, 15, 18, 32, 40, 64, 96, 130):
            for kh, kw in ((7, 7), (3, 3), (5, 5), (7, 3), (11, 11)):
                for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                                 (None, None)):
                    shape = (2, h, w, c)
                    assert kstem.supported(shape, tdt, kh, kw) == \
                        jstem.supported(shape, jdt, kh, kw), (shape, kh, kw)
                    n += 1
    assert n > 500
    for c in (15, 3, 18):  # the flagship stems
        assert kstem.supported((1, 480, 640, c), torch.bfloat16)


@pytest.mark.parametrize("which,relu", [("conv", False), ("conv", True),
                                        ("stem", False)])
def test_conv_gradients_match_jax_vjp(which, relu):
    """d(x, kernel, bias) of sum(out * g) through the port's
    autograd.Function against jax.grad through the Pallas custom VJP."""
    if which == "conv":
        shape, o, kh = (1, 8, 16, 64), 64, 3
        fwd_j = lambda x, k, b: jconv.conv2d_pallas(x, k, b, True, relu)
        fwd_t = lambda x, w, b: kconv.conv2d(x, w, b, relu)
        out_hw = shape[1:3]
    else:
        shape, o, kh = (1, 16, 32, 15), 64, 7
        fwd_j = lambda x, k, b: jstem.stem_conv_pallas(x, k, b, True)
        fwd_t = kstem.stem_conv
        out_hw = (shape[1] // 2, shape[2] // 2)
    x, k, b = _case(2, shape, o, kh, kh)
    g = np.random.default_rng(3).standard_normal(
        (shape[0], *out_hw, o)).astype(np.float32)

    def loss_j(x, k, b):
        return (fwd_j(x.astype(jnp.bfloat16), k, b).astype(jnp.float32)
                * g).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt, wt, bt = _to_port(x, k, b)
    xt = xt.float().requires_grad_(True)  # the JAX x is f32 too
    wt.requires_grad_(True)
    bt.requires_grad_(True)
    out = fwd_t(xt.bfloat16(), wt, bt)
    (out.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    got = (_nhwc(xt.grad), wt.grad.permute(2, 3, 1, 0).numpy(),
           bt.grad.numpy())
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    for name, a, w_, tol in zip(("x", "kernel", "bias"), got, want,
                                (2.0 ** -6, 2.0 ** -6, 5e-2)):
        w_ = np.asarray(w_, np.float32)
        err = np.abs(a - w_).max() / np.abs(w_).max()
        assert err < tol, (name, err)
    g_bf16 = torch.from_numpy(g).bfloat16().double()
    exact = g_bf16.sum(dim=(0, 1, 2)).numpy()
    if relu:  # the bias cotangent only passes where the output is > 0
        ref = conv_common.conv_ref_bf16(*_to_port(x, k, b), 1, True)
        exact = (g_bf16 * (ref > 0).permute(0, 2, 3, 1)).sum(
            dim=(0, 1, 2)).numpy()
    assert np.abs(got[2] - exact).max() <= ULP * np.abs(exact).max()


def test_wrappers_take_plain_version_on_cpu():
    x, k, b = _case(4, (1, 8, 16, 64), 64, 3, 3)
    xt, wt, bt = _to_port(x, k, b)
    before = (kconv.launches, kstem.launches)
    assert torch.equal(kconv.conv2d(xt, wt, bt, True),
                       kconv.conv2d_plain(xt, wt, bt, True))
    assert torch.equal(kstem.stem_conv(xt, wt, bt),
                       kstem.stem_conv_plain(xt, wt, bt))
    assert (kconv.launches, kstem.launches) == before


def test_plain_version_rounds_once():
    """f32 bias added before the one rounding: the kernels' function, not
    the default path's bf16 conv plus bf16 bias."""
    x, k, b = _case(5, (1, 6, 8, 32), 48, 3, 3)
    xt, wt, bt = _to_port(x, k, b)
    got = kconv.conv2d_plain(xt, wt, bt)
    f32 = torch.nn.functional.conv2d(xt.float(), wt.bfloat16().float(),
                                     bt, 1, 1)
    assert torch.equal(got, f32.bfloat16())
    ref = conv_common.conv_ref_bf16(xt, wt, bt, 1)
    assert ref.dtype == torch.bfloat16
    assert (got.float() - ref.float()).abs().max() <= 2 * ULP * (
        ref.float().abs().max())


@pytest.mark.parametrize("bad", ["f32_x", "even_window", "channels",
                                 "bias_shape", "int_weight", "rank"])
def test_conv_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(1, 8, 6, 10, dtype=torch.bfloat16)
    w = torch.zeros(16, 8, 3, 3)
    b = torch.zeros(16)
    if bad == "f32_x":
        x = x.float()
    elif bad == "even_window":
        w = torch.zeros(16, 8, 2, 2)
    elif bad == "channels":
        w = torch.zeros(16, 4, 3, 3)
    elif bad == "bias_shape":
        b = torch.zeros(8)
    elif bad == "int_weight":
        w = w.int()
    else:
        x = x[0]
    for fn in (lambda: kconv.conv2d(x, w, b), lambda: kstem.stem_conv(x, w, b)):
        with pytest.raises((ValueError, TypeError)):
            fn()


# ---------------------------------------------------------------------------
# around the kernels: layouts, the prepared-weight cache, the tile plan


def _layouts(xt: torch.Tensor):
    """The same values NCHW-contiguous, channels-last and as a
    non-contiguous slice of a larger tensor."""
    n, c, h, w = xt.shape
    big = torch.zeros(n, c + 2, h + 1, w + 3, dtype=xt.dtype)
    big[:, 1:c + 1, 1:, 2:w + 2] = xt
    return {"nchw": xt.contiguous(),
            "channels_last": xt.contiguous(memory_format=torch.channels_last),
            "sliced": big[:, 1:c + 1, 1:, 2:w + 2]}


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "sliced"])
@pytest.mark.parametrize("which", ["conv", "stem"])
def test_wrappers_take_any_layout_and_return_channels_last(which, layout):
    x, k, b = _case(6, (2, 12, 12, 8), 40, 3, 3)  # NHWC
    xt, wt, bt_ = _to_port(x, k, b)
    xs = _layouts(xt)
    assert not xs["sliced"].is_contiguous()
    fn = ((lambda t: kconv.conv2d(t, wt, bt_, True)) if which == "conv"
          else (lambda t: kstem.stem_conv(t, wt, bt_)))
    want = fn(xs["nchw"])
    got = fn(xs[layout])
    assert torch.equal(got, want)
    # the memory format the CUDA path documents
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == ((2, 40, 12, 12) if which == "conv"
                         else (2, 40, 6, 6))
    # and under autograd (ConvFn) as well
    wg = wt.clone().requires_grad_(True)
    out = (kconv.conv2d(xs[layout], wg, bt_, True) if which == "conv"
           else kstem.stem_conv(xs[layout], wg, bt_))
    assert out.requires_grad and torch.equal(out.detach(), want)
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_no_autograd_node_without_a_gradient_to_take():
    x, k, b = _case(7, (1, 6, 8, 16), 32, 3, 3)
    xt, wt, bt_ = _to_port(x, k, b)
    assert kconv.conv2d(xt, wt, bt_).grad_fn is None
    wt.requires_grad_(True)
    assert kconv.conv2d(xt, wt, bt_).grad_fn is not None
    with torch.no_grad():
        assert kconv.conv2d(xt, wt, bt_).grad_fn is None


def test_kernel_input_passes_channels_last_through():
    x = torch.randn(2, 16, 5, 7).bfloat16()
    x_cl = x.contiguous(memory_format=torch.channels_last)
    conv_common.reset_counters()
    assert conv_common.kernel_input(x_cl, 16) is x_cl
    assert conv_common.layout_copies == 0
    for t, cp in ((x, 16), (x_cl[:, :12], 16), (x_cl[:, :, 1:], 16)):
        got = conv_common.kernel_input(t, cp)
        assert got.shape == (2, cp, *t.shape[2:])
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got[:, :t.shape[1]], t)
        assert not got[:, t.shape[1]:].any()
    assert conv_common.layout_copies == 3


def _prepared_matches(prep, w, b):
    o, c, kh, kw = w.shape
    assert prep.w.shape == (o, kh, kw, prep.cp) and prep.cp % 8 == 0
    assert prep.w.dtype == torch.bfloat16 and prep.w.is_contiguous()
    assert torch.equal(prep.w[..., :c],
                       w.detach().bfloat16().permute(0, 2, 3, 1))
    assert not prep.w[..., c:].any()
    assert prep.b.dtype == torch.float32
    assert torch.equal(prep.b, b.detach().float())


@pytest.mark.parametrize("update", ["add_", "optimizer", "load_state_dict",
                                    "data", "bias"])
def test_prepared_weight_cache_is_never_stale(update):
    conv = torch.nn.Conv2d(12, 40, 3)
    w, b = conv.weight, conv.bias
    conv_common.reset_counters()
    first = conv_common.prepared(w, b)
    assert conv_common.prepared(w, b) is first
    assert conv_common.weight_preps == 1
    _prepared_matches(first, w, b)
    if update == "add_":
        with torch.no_grad():
            w.add_(1.0)
    elif update == "optimizer":
        opt = torch.optim.AdamW(conv.parameters(), lr=0.1)
        conv(torch.randn(1, 12, 5, 5)).sum().backward()
        opt.step()
    elif update == "load_state_dict":
        conv.load_state_dict({"weight": torch.randn_like(w),
                              "bias": torch.randn_like(b)})
    elif update == "data":
        w.data = torch.randn_like(w)
    else:
        with torch.no_grad():
            b.mul_(3.0)
    second = conv_common.prepared(w, b)
    assert second is not first and conv_common.weight_preps == 2
    _prepared_matches(second, w, b)
    assert conv_common.prepared(w, b) is second
    # another parameter of the same shape has its own entry
    other = torch.nn.Conv2d(12, 40, 3)
    third = conv_common.prepared(other.weight, other.bias)
    assert third is not second
    assert conv_common.prepared(w, b) is second


def test_cached_values_go_with_their_sources():
    import gc

    w, b = torch.randn(8, 8, 3, 3), torch.randn(8)
    conv_common.prepared(w, b)
    n = len(conv_common._derived)
    del w, b
    gc.collect()
    assert len(conv_common._derived) == n - 1


def _opt_cfg():
    return dataclasses.replace(bt.flagship_config(), pallas_stem=True,
                               pallas_conv=True)


def _plan_rows():
    rows = [(r, "B=1 480x640") for r in chip_smoke.flagship_convs(_opt_cfg())]
    rows += [(r, "B=3 288x384") for r in chip_smoke.flagship_convs(
        _opt_cfg(), chip_smoke.TRAIN_B, chip_smoke.TRAIN_H,
        chip_smoke.TRAIN_W)]
    return [(r, at) for r, at in rows if r["kernel"]]


def _check_plan(plan, m, o):
    assert plan.legal(), plan
    assert (plan.bm, plan.bn) in conv_common.VARIANTS
    assert plan.stages == conv_common.VARIANTS[(plan.bm, plan.bn)]
    assert plan.bm in (64, 128) and plan.threads == 2 * plan.bm <= 1024
    assert plan.bn % 8 == 0 and plan.bn <= 256  # a wgmma width
    assert plan.stages >= 3  # the ring's prefetch distance is stages - 2
    assert plan.smem_bytes <= 232_448
    assert plan.split in (1, 2, 4)  # a portable cluster size
    gx, gy, gz = plan.grid(m, o)
    assert gx * plan.bm >= m > (gx - 1) * plan.bm
    assert gy * plan.bn >= o > (gy - 1) * plan.bn
    assert gz == plan.split and gx < 2 ** 31 and gy < 65536


@pytest.mark.parametrize("i", range(53))
def test_tile_plan_is_legal_at_every_flagship_shape(i):
    rows = _plan_rows()
    # 26 shapes at 480x640, 27 at 288x384 (there the fused 1x5 GRU conv
    # passes its gate too)
    assert len(rows) == 53
    row, _ = rows[i]
    n, c, h, w = row["shape"]
    s = row["stride"]
    m = n * ((h - 1) // s + 1) * ((w - 1) // s + 1)
    k = row["kh"] * row["kw"] * (-(-c // 8) * 8)
    plan = conv_common.tile_plan(m, row["cout"], k)
    _check_plan(plan, m, row["cout"])
    if plan.split > 1:  # every block of the cluster has K steps to do
        assert -(-k // conv_common.BK) >= 4 * plan.split
    if m >= 100_000:  # the encoders' large maps: 128-pixel blocks
        assert plan.bm == 128 and plan.bn >= row["cout"]


@pytest.mark.parametrize("m,o,k", [(1, 32, 8), (63, 124, 392), (65, 33, 72),
                                   (4800, 124, 2304), (4799, 385, 40),
                                   (9 * 13, 64, 72), (11 * 7 * 2, 124, 392),
                                   (10 ** 6 + 1, 1000, 27 * 8),
                                   (2 ** 31 - 200, 64, 8), (17, 2048, 4096)])
def test_tile_plan_is_legal_at_ragged_shapes(m, o, k):
    plan = conv_common.tile_plan(m, o, k)
    _check_plan(plan, m, o)
    assert plan is conv_common.tile_plan(m, o, k)  # cached per shape


def test_every_built_variant_is_a_legal_plan():
    plans = conv_common.all_plans()
    assert len(plans) == 18 and len(set(plans)) == 18
    for plan in plans:
        _check_plan(plan, 4800, 128)
    assert not conv_common.TilePlan(128, 256, 4, 1).legal()
    assert not conv_common.TilePlan(64, 64, 6, 3).legal()
    assert not conv_common.TilePlan(64, 64, 4, 1).legal()


def test_forced_plan_is_checked_before_any_launch():
    """A variant the kernels are not built for raises before the
    library is looked up (so also on a machine without nvcc)."""
    with pytest.raises(ValueError, match="not built"):
        conv_common._launch_args("conv3x3", (1, 8, 4, 4), 8, 3, 3, 8, 1,
                                 False, conv_common.TilePlan(192, 64, 4, 1))


# the conv3x3 rows that take the pipelined loop at B=1 (the encoders' large
# maps); at the bf16 cell's B=16 every conv3x3 row but convf1's (Cp 8)
PIPELINED_AT_B1 = {"fnet_ev layer1_0.conv1 3x3/s1", "fnet_ev layer2 3x3",
                   "fnet_img layer1_0.conv1 3x3/s1",
                   "cnet layer1_0.conv1 3x3/s1"}


def _loop_rows():
    rows = []
    for n in (1, chip_smoke.BF16_CELL_BATCH):
        rows += [(r, n) for r in chip_smoke.flagship_convs(
            chip_smoke.opt_in_config(), n=n) if r["kernel"] == "conv3x3"]
    return rows


@pytest.mark.parametrize("i", range(34))
def test_pipelined_routing_at_every_flagship_shape(i):
    """The loop a conv3x3 launch takes is a function of (M, O, K, Cp)
    alone: launch_plan is tile_plan's plan with the pipelined flag where
    ``pipelined`` says so, 128-pixel tiles without a K split and Cp a
    multiple of 32; at B=16 every conv3x3 launch but convf1's, at B=1 the
    encoders' large maps."""
    rows = _loop_rows()
    assert len(rows) == 34  # 17 conv3x3 shapes at each batch
    row, n = rows[i]
    m, o, k, cp = chip_smoke.conv_mok(row)
    plan = conv_common.launch_plan(m, o, k, cp, 1)
    other = conv_common.tile_plan(m, o, k)
    assert plan == (conv_common.pipelined_plan(other.bn) if plan.pipelined
                    else other)
    assert plan.legal()
    assert plan.pipelined is conv_common.pipelined(m, o, k, cp)
    if n == 1:
        want = row["what"][0] in PIPELINED_AT_B1
    else:
        want = not row["what"][0].startswith("update convf1")
    assert plan.pipelined is want, (row["what"], n, plan)
    if plan.pipelined:
        assert plan.bm == 128 and plan.split == 1 and cp % 32 == 0
        assert -(-m // 128) * -(-o // plan.bn) >= (
            conv_common.PIPELINED_MIN_TILES)
    assert not conv_common.launch_plan(m, o, k, cp, 2).pipelined


@pytest.mark.parametrize("m,o,k,cp,want", [
    (10 ** 6 + 1, 1000, 9 * 96, 96, True),     # Cp 96: 32-channel boxes
    (76_800, 124, 9 * 256, 256, True),         # O 124: 8-byte stores
    (76_800, 192, 9 * 256, 256, True),
    (76_800, 128, 49 * 8, 8, False),           # convf1: Cp 8
    (76_800, 64, 9 * 40, 40, False),           # Cp not a multiple of 32
    (4800, 128, 9 * 128, 128, False),          # B=1 update block: 38 tiles
    (128 * 527, 64, 9 * 64, 64, False),        # one tile short
    (128 * 528, 64, 9 * 64, 64, True),
    (128 * 528 - 1, 64, 9 * 64, 64, True),     # the last tile in part
    (2 ** 31 - 200, 64, 9 * 64, 64, True)])
def test_pipelined_routing_at_ragged_shapes(m, o, k, cp, want):
    assert conv_common.pipelined(m, o, k, cp) is want
    plan = conv_common.launch_plan(m, o, k, cp, 1)
    assert plan.pipelined is want and plan.legal()
    other = conv_common.tile_plan(m, o, k)
    assert plan == (conv_common.pipelined_plan(other.bn) if want else other)


def test_pipelined_plan_is_checked_before_any_launch():
    """A pipelined plan the loop does not take (Cp not a multiple of 32, a
    stride of 2, other than 128-pixel tiles of 64, 96 or 128 channels, a K
    split, a ring of the other loop's stages) raises before the library
    is looked up."""
    pipe = conv_common.pipelined_plan(64)
    assert pipe.legal() and pipe == conv_common.TilePlan(128, 64, 0, 1, True)
    assert all(conv_common.pipelined_plan(bn).legal() for bn in (96, 128))
    assert not conv_common.pipelined_plan(32).legal()
    assert not conv_common.TilePlan(64, 64, 0, 1, pipelined=True).legal()
    assert not conv_common.TilePlan(128, 64, 0, 2, pipelined=True).legal()
    assert not conv_common.TilePlan(128, 64, 4, 1, pipelined=True).legal()
    for name, cp, stride in (("conv3x3", 8, 1), ("conv3x3", 40, 1),
                             ("stem_conv", 64, 2)):
        with pytest.raises(ValueError, match="not built"):
            conv_common._launch_args(name, (1, cp, 8, 16), 64, 3, 3, cp,
                                     stride, False, pipe)


def test_pipelined_counter_stays_zero_on_cpu_and_in_f32():
    """On the CPU the wrapper runs the plain version and counts no launch
    of either loop, at a shape the rule sends to the pipelined loop; the
    derived count is 0 in f32 and 126 / 15 at bf16 (B=16 / B=1)."""
    from bflow_tpu_torch import kernels

    x = torch.randn(1, 32, 264, 256).bfloat16()
    w = torch.randn(64, 32, 3, 3) / 17.0
    b = torch.randn(64)
    assert conv_common.pipelined(264 * 256, 64, 9 * 32, 32)
    kernels.reset_launch_counts()
    assert torch.equal(kconv.conv2d(x, w, b, True),
                       kconv.conv2d_plain(x, w, b, True))
    counts = kernels.launch_counts()
    assert counts[kconv.PIPELINED_NAME] == counts[kconv.NAME] == 0
    cfg = chip_smoke.opt_in_config()
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              corr_precision="float32")
    for n in (1, 16):
        assert chip_smoke.expected_launches(f32, n)[kconv.PIPELINED_NAME] == 0
    assert chip_smoke.expected_launches(cfg, 16)[kconv.PIPELINED_NAME] == 126
    assert chip_smoke.expected_launches(cfg, 16)[kconv.NAME] == 138
    assert chip_smoke.expected_launches(cfg, 1)[kconv.PIPELINED_NAME] == 15


@pytest.mark.parametrize("update", ["none", "add_", "load_state_dict"])
def test_gru_fused_weights_follow_the_parameters(update):
    """The fused GRU weights are made once per parameter value where no
    gradient can be asked for, and anew after an update: the fused pass
    gives what a fresh module with the same parameters gives."""
    from bflow_tpu_torch.models.update import SepConvGRU

    torch.manual_seed(0)
    gru = SepConvGRU(16, 24, torch.bfloat16, use_kernel=True)
    h = torch.randn(1, 16, 12, 16).bfloat16()
    x = torch.randn(1, 24, 12, 16).bfloat16()
    with torch.no_grad():
        first = gru(h, x)
        params = gru._fused_params("1")
        assert all(a is b for a, b in zip(params, gru._fused_params("1")))
        if update == "add_":
            gru.convq1.weight.add_(0.25)
            gru.convz2.bias.add_(0.5)
        elif update == "load_state_dict":
            gru.load_state_dict({k: v + 0.125
                                 for k, v in gru.state_dict().items()})
        again = gru._fused_params("1")
        assert (again[0] is params[0]) == (update == "none")
        got = gru(h, x)
    fresh = SepConvGRU(16, 24, torch.bfloat16, use_kernel=True)
    fresh.load_state_dict(gru.state_dict())
    with torch.no_grad():
        want = fresh(h, x)
    assert torch.equal(got, want)
    assert torch.equal(got, first) == (update == "none")
    # under autograd the fused weights are built in the graph
    out = gru(h, x)
    out.float().sum().backward()
    assert gru.convq1.weight.grad is not None
    assert gru.convz1.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("kind", ["instance", "batch", "group", "none"])
@pytest.mark.parametrize("training", [False, True])
def test_norms_keep_a_channels_last_activation(kind, training):
    """What stands between two convs keeps the kernels' channels-last
    layout (so the next conv reads it in place) and computes the same
    values as on an NCHW-contiguous tensor."""
    from bflow_tpu_torch.models.extractor import make_norm

    torch.manual_seed(1)
    norm = make_norm(kind, 16, 2).train(training)
    x = torch.randn(2, 16, 6, 10).bfloat16()
    x_cl = x.contiguous(memory_format=torch.channels_last)
    want = torch.relu(norm(x))
    got = torch.relu(norm(x_cl))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert not got.is_contiguous()
    # the same arithmetic; reductions may run in another order
    got, want = got.detach().float(), want.detach().float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ULP * want.abs().max().item())
