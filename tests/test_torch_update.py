"""Port parity: update block (motion encoder, SepConvGRU, heads) against
the JAX update block under identical weights and inputs, with the
correlation input in both forms (concatenated map, per-level lookups).
f32, rtol=1e-5 and atol=1e-5 in units of max(1, max|reference|)
(test_torch_common.assert_close): the random-init Bezier head's outputs
reach the tens."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflow_tpu.models import update as jupd
from bflow_tpu_torch.models import update as tupd
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    assert_close,
    configs,
    nchw_to_nhwc,
    nhwc_to_nchw,
    random_variables,
)

N, H1, W1 = 1, 8, 8


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    net = np.tanh(rng.standard_normal((N, H1, W1, cfg.hidden_dim))).astype(
        np.float32)
    inp = np.maximum(rng.standard_normal((N, H1, W1, cfg.context_dim)),
                     0).astype(np.float32)
    bez = (2 * rng.standard_normal((N, H1, W1, 2 * cfg.bezier_degree))
           ).astype(np.float32)
    per_level = [rng.standard_normal((tl, N, H1, W1, 81)).astype(np.float32)
                 for tl in (5, 2, 2, 2)]
    concat = np.concatenate(
        [f.transpose(1, 2, 3, 0, 4).reshape(N, H1, W1, -1)
         for f in per_level], axis=-1)
    return net, inp, bez, per_level, concat


@pytest.fixture(scope="module")
def blocks():
    """One JAX init/apply per correlation form, shared by the tests."""
    out = {}
    for fused in (False, True):
        jcfg, tcfg = configs(fuse_corr_conv=fused)
        net, inp, bez, per_level, concat = _inputs(jcfg, 1)
        corr_j = [jnp.asarray(f) for f in per_level] if fused else (
            jnp.asarray(concat))
        jblk = jupd.BasicUpdateBlock(jcfg)
        args = (jnp.asarray(net), jnp.asarray(inp), corr_j, jnp.asarray(bez))
        variables = random_variables(
            lambda: jblk.init(jax.random.PRNGKey(0), *args), 2)
        want = [np.asarray(a) for a in jblk.apply(variables, *args)]
        tblk = tupd.BasicUpdateBlock(tcfg)
        load_jax_variables(tblk, variables)
        corr_t = ([torch.from_numpy(f) for f in per_level] if fused
                  else torch.from_numpy(concat))
        with torch.no_grad():
            got = tblk.eval()(nhwc_to_nchw(net), nhwc_to_nchw(inp), corr_t,
                              nhwc_to_nchw(bez))
        out[fused] = (variables, got, want, tcfg,
                      (net, inp, bez, per_level, concat))
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("which", ["net", "mask", "delta"])
def test_update_block_matches_jax(blocks, fused, which):
    _, got, want, _, _ = blocks[fused]
    i = ("net", "mask", "delta").index(which)
    g = nchw_to_nhwc(got[i])
    assert g.shape == want[i].shape
    if which != "net":
        assert got[i].dtype == torch.float32  # heads emit f32
    assert_close(g, want[i])


def test_fused_and_concat_corr_forms_agree(blocks):
    """Same weights, same lookups: the fused convc1 equals the concat one."""
    variables, _, _, _, (net, inp, bez, per_level, concat) = blocks[True]
    outs = []
    for fused in (False, True):
        _, tcfg = configs(fuse_corr_conv=fused)
        blk = load_jax_variables(tupd.BasicUpdateBlock(tcfg), variables)
        corr = ([torch.from_numpy(f) for f in per_level] if fused
                else torch.from_numpy(concat))
        with torch.no_grad():
            outs.append(blk.eval()(nhwc_to_nchw(net), nhwc_to_nchw(inp),
                                   corr, nhwc_to_nchw(bez)))
    for a, b in zip(*outs):
        assert_close(a.numpy(), b.numpy())


def test_sep_conv_gru_matches_fused_jax_gru():
    """The port's per-gate GRU equals the JAX fused [z|r|q_x] form."""
    rng = np.random.default_rng(3)
    h = np.tanh(rng.standard_normal((2, 6, 7, 16))).astype(np.float32)
    x = rng.standard_normal((2, 6, 7, 24)).astype(np.float32)
    jgru = jupd.SepConvGRU(16)
    variables = random_variables(
        lambda: jgru.init(jax.random.PRNGKey(0), jnp.asarray(h),
                          jnp.asarray(x)), 4)
    want = np.asarray(jgru.apply(variables, jnp.asarray(h), jnp.asarray(x)))
    tgru = load_jax_variables(tupd.SepConvGRU(16, 24), variables)
    with torch.no_grad():
        got = nchw_to_nhwc(tgru(nhwc_to_nchw(h), nhwc_to_nchw(x)))
    assert_close(got, want)


def test_update_block_state_dict_names():
    """Reference checkpoint names (tests/test_importer.py)."""
    _, tcfg = configs()
    keys = set(tupd.BasicUpdateBlock(tcfg).state_dict())
    for k in ("encoder.convc1.weight", "encoder.convf1.bias",
              "gru.convz1.weight", "gru.convq2.bias",
              "bezier_head.conv2.weight", "mask.0.weight", "mask.2.bias"):
        assert k in keys, k
    assert len([k for k in keys if k.startswith("gru.")]) == 12


def test_update_block_bf16_types(blocks):
    """bf16 compute: the hidden state stays bf16, the heads emit f32. (The
    bf16 precision bound is asserted end to end, tests/test_torch_model.)"""
    variables, got32, _, _, (net, inp, bez, per_level, _) = blocks[True]
    _, tcfg = configs(fuse_corr_conv=True, compute_dtype="bfloat16")
    blk = load_jax_variables(tupd.BasicUpdateBlock(tcfg), variables)
    with torch.no_grad():
        got = blk.eval()(nhwc_to_nchw(net).bfloat16(), nhwc_to_nchw(inp),
                         [torch.from_numpy(f).bfloat16() for f in per_level],
                         nhwc_to_nchw(bez))
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, got32):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
