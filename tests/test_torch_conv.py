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
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
