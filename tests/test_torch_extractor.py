"""Port parity: BasicEncoder with every norm, against the JAX encoder under
identical weights (numpy-drawn, carried by bflow_tpu_torch.weights) and
inputs, at the model's feature width (256).

f32, rtol=1e-5 and atol=1e-5 in units of the output's largest magnitude:
through 15 convs and instance norms over 8x8 maps, both packages sit about
1e-6 of that magnitude from a float64 evaluation of the same network, so a
plain atol=1e-5 would test the summation order of two f32 conv libraries
rather than the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.models import extractor as jext
from bflow_tpu_torch.models import extractor as text
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    assert_close,
    nchw_to_nhwc,
    nhwc_to_nchw,
    random_variables,
    rel_err,
)

NORMS = ["group", "batch", "instance", "none"]


def _pair(norm, cin, cout, seed, x):
    jenc = jext.BasicEncoder(cout, norm)
    variables = random_variables(
        lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    tenc = text.BasicEncoder(cin, cout, norm)
    load_jax_variables(tenc, variables)
    return jenc, variables, tenc.eval()


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 64, 5)).astype(np.float32)
    out = {}
    for i, norm in enumerate(NORMS):
        jenc, variables, tenc = _pair(norm, 5, 256, 10 + i, x)
        want = np.asarray(jenc.apply(variables, jnp.asarray(x)))
        out[norm] = (jenc, variables, tenc, x, want)
    return out


@pytest.mark.parametrize("norm", NORMS)
def test_encoder_f32_matches_jax(encoders, norm):
    _, _, tenc, x, want = encoders[norm]
    with torch.no_grad():
        got = nchw_to_nhwc(tenc(nhwc_to_nchw(x)))
    assert got.shape == want.shape == (1, 8, 8, 256)
    assert_close(got, want)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_encoder_list_input_is_one_batched_call(encoders, norm):
    jenc, variables, tenc, x, _ = encoders[norm]
    parts = [x, x[:, ::-1] * 0.5, x[:, :, ::-1]]
    want = jenc.apply(variables, [jnp.asarray(p) for p in parts])
    with torch.no_grad():
        got = tenc([nhwc_to_nchw(p) for p in parts])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_close(nchw_to_nhwc(g), w)


def test_encoder_state_dict_names():
    """Reference checkpoint names (tests/test_importer.py), no norm3."""
    keys = set(text.BasicEncoder(5, 24, "batch").state_dict())
    for k in ("conv1.weight", "norm1.running_mean", "layer1.0.conv1.weight",
              "layer2.0.downsample.0.weight",
              "layer2.0.downsample.1.running_var", "layer3.1.norm2.bias",
              "conv2.bias"):
        assert k in keys, k
    assert not any("norm3" in k for k in keys)
    assert "layer1.0.downsample.0.weight" not in keys  # stride-1 stage


@pytest.mark.parametrize("norm", ["group", "batch", "instance"])
def test_norm_bf16_matches_jax(norm):
    """bf16 norms take f32 statistics and cast back once; instance norm
    takes the single-pass variance of the JAX fast mode. Agreement to one
    bf16 rounding (2^-8 relative)."""
    rng = np.random.default_rng(3)
    c = 32
    x = (rng.standard_normal((2, 9, 11, c)) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    mod = jext.Norm(norm, num_groups=4, dtype=jnp.bfloat16)
    variables = random_variables(lambda: mod.init(jax.random.PRNGKey(0), xj),
                                 4) if norm != "instance" else {}
    want = np.asarray(mod.apply(variables, xj), np.float32)
    tnorm = text.make_norm(norm, c, 4)
    if variables:  # the wrapper is unwrapped below a norm module's name
        holder = torch.nn.Module()
        holder.norm1 = tnorm
        load_jax_variables(holder, {coll: {"norm1": tree}
                                    for coll, tree in variables.items()})
    tnorm.eval()
    xt = nhwc_to_nchw(x).bfloat16()
    got = tnorm(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_instance_norm_single_pass_variance_formula():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((1, 3, 6, 7)) * 2 + 4).astype(
        np.float32)).bfloat16()
    xf = x.float()
    m1 = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf ** 2).mean(dim=(2, 3), keepdim=True) - m1 ** 2).clamp(min=0)
    want = ((xf - m1) * torch.rsqrt(var + 1e-5)).bfloat16()
    assert torch.equal(text.InstanceNorm()(x), want)


def test_encoder_bf16_close_to_f32(encoders):
    """The bf16 encoder (convs in bf16 with f32 accumulation, norms with
    f32 statistics) stays within a few bf16 roundings of the f32 one."""
    _, variables, tenc, x, _ = encoders["instance"]
    t16 = text.BasicEncoder(5, 256, "instance",
                             compute_dtype=torch.bfloat16)
    load_jax_variables(t16, variables)
    with torch.no_grad():
        ref = nchw_to_nhwc(tenc(nhwc_to_nchw(x)))
        got = t16.eval()(nhwc_to_nchw(x))
    assert got.dtype == torch.bfloat16
    assert rel_err(nchw_to_nhwc(got), ref) < 5e-2


def test_kaiming_out_init_statistics():
    """fan-out, gain 2, truncated at 2 std: the JAX kaiming_out."""
    g = torch.Generator().manual_seed(0)
    w = torch.empty(256, 64, 3, 3)
    text.kaiming_out_(w, g)
    std = np.sqrt(2.0 / (256 * 9))
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    enc = text.BasicEncoder(5, 24, "batch")
    text.init_weights(enc, torch.Generator().manual_seed(1))
    assert all(b.abs().max() == 0 for n, b in enc.named_parameters()
               if n.endswith("conv1.bias"))
