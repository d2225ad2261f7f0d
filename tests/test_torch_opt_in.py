"""Port parity of the opt-in conv modes (pallas_stem, pallas_conv) and of
the full opt-in forward (pallas_q8 + pallas_stem + pallas_conv) against the
JAX package with the same switches, its Pallas kernels run in interpret
mode (BFLOW_PALLAS_INTERPRET=1, corr._INTERPRET), on numpy-drawn weights.

Everything here is bf16 (the conv kernels' gates pass only in the bf16
fast mode), so the two packages agree to bf16 noise, not to f32 digits:
a conv output that rounds to the neighbouring bf16 value in one package
(2^-8 relative) is carried through the following convs and norms. Bounds
are relative max errors, stated with each test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu.models import RAFTSpline as JaxRAFTSpline
from bflow_tpu.models import corr as jcorr
from bflow_tpu.models import extractor as jext
from bflow_tpu.models import update as jupd
from bflow_tpu_torch.kernels import conv3x3 as kconv
from bflow_tpu_torch.kernels import corr_lookup as klookup
from bflow_tpu_torch.kernels import stem_conv as kstem
from bflow_tpu_torch.models import extractor as text
from bflow_tpu_torch.models import update as tupd
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    configs,
    damp_head,
    make_inputs,
    nchw_to_nhwc,
    nhwc_to_nchw,
    random_variables,
    rel_err,
)

BF16 = dict(compute_dtype="bfloat16", corr_precision="bfloat16")


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode: the convs read
    the variable at call time, the lookup at import."""
    monkeypatch.setenv("BFLOW_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jcorr, "_INTERPRET", True)


class _Calls:
    """Counts the conv kernel wrappers' calls by shape (on the CPU they run
    the plain versions, so the launch counters stay at 0)."""

    def __init__(self, monkeypatch):
        self.calls = {kconv.NAME: [], kstem.NAME: []}
        for mod, name in ((kconv, "conv2d"), (kstem, "stem_conv")):
            fn = getattr(mod, name)

            def counted(x, *a, _fn=fn, _name=mod.NAME, **kw):
                self.calls[_name].append(tuple(x.shape))
                return _fn(x, *a, **kw)

            monkeypatch.setattr(mod, name, counted)

    def counts(self):
        return {k: len(v) for k, v in self.calls.items()}


def test_encoder_with_kernels_matches_jax(interpret, monkeypatch):
    """fnet's encoder (instance norm, 256 outputs) with stem and conv
    kernels against the JAX encoder with stem_pallas and conv_pallas:
    every conv of it passes the gates here (1 stem, 2 stride-2 3x3s, 10
    stride-1 3x3s). Bound 3e-2: instance norm over 4x6 maps amplifies one
    bf16 flip (measured 1.3e-2; the port's default path is 1.6e-2 away)."""
    x = np.random.default_rng(0).standard_normal((2, 32, 48, 15)).astype(
        np.float32)
    jenc = jext.BasicEncoder(256, "instance", dtype=jnp.bfloat16,
                             stem_pallas=True, conv_pallas=True)
    variables = random_variables(
        lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(x)),
                      np.float32)
    tenc = load_jax_variables(text.BasicEncoder(
        15, 256, "instance", torch.bfloat16, stem_kernel=True,
        conv_kernel=True), variables).eval()
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got = tenc(nhwc_to_nchw(x))
    assert got.dtype == torch.bfloat16
    assert calls.counts() == {kconv.NAME: 10, kstem.NAME: 3}
    assert calls.calls[kstem.NAME][0] == (2, 15, 32, 48)
    assert rel_err(nchw_to_nhwc(got), want) < 3e-2


@pytest.fixture(scope="module")
def update_blocks():
    """The JAX update block with pallas_conv (interpret) and its inputs."""
    import os

    jcfg, tcfg = configs(pallas_conv=True, fuse_corr_conv=True, **BF16)
    rng = np.random.default_rng(1)
    n, h1, w1 = 1, 12, 8
    net = np.tanh(rng.standard_normal((n, h1, w1, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((n, h1, w1, 128)), 0).astype(
        np.float32)
    bez = (2 * rng.standard_normal((n, h1, w1, 4))).astype(np.float32)
    corr = [rng.standard_normal((tl, n, h1, w1, 81)).astype(np.float32)
            for tl in (5, 2, 2, 2)]
    jblk = jupd.BasicUpdateBlock(jcfg)
    args = (jnp.asarray(net, jnp.bfloat16), jnp.asarray(inp, jnp.bfloat16),
            [jnp.asarray(c, jnp.bfloat16) for c in corr], jnp.asarray(bez))
    variables = random_variables(
        lambda: jblk.init(jax.random.PRNGKey(0), *args), 2)
    old = os.environ.get("BFLOW_PALLAS_INTERPRET")
    os.environ["BFLOW_PALLAS_INTERPRET"] = "1"
    try:
        want = [np.asarray(a, np.float32)
                for a in jax.jit(jblk.apply)(variables, *args)]
    finally:
        if old is None:
            del os.environ["BFLOW_PALLAS_INTERPRET"]
        else:
            os.environ["BFLOW_PALLAS_INTERPRET"] = old
    tin = (nhwc_to_nchw(net).bfloat16(), nhwc_to_nchw(inp).bfloat16(),
           [torch.from_numpy(c).bfloat16() for c in corr], nhwc_to_nchw(bez))
    return variables, tcfg, tin, want


def test_update_block_with_conv_kernel_matches_jax(update_blocks,
                                                   monkeypatch):
    """The update block under pallas_conv against JAX's: the same 9
    convs take the kernel (at 12x8 the fused 1x5 GRU conv passes the gate
    as well: 10), the GRU in the fused form. Bound 2e-2 of each output's
    max: a bf16 flip carried through 5 convs and the GRU."""
    variables, tcfg, tin, want = update_blocks
    blk = load_jax_variables(tupd.BasicUpdateBlock(tcfg), variables).eval()
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        got = blk(*tin)
    assert calls.counts() == {kconv.NAME: 10, kstem.NAME: 0}
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert rel_err(nchw_to_nhwc(g), w) < 2e-2


def test_fused_gru_equals_per_gate_gru_in_f32():
    """The fused gate decomposition that pallas_conv selects is the same
    function as the per-gate GRU (exact in f32, up to summation order)."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(np.tanh(rng.standard_normal((1, 16, 5, 7))).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 24, 5, 7)).astype(
        np.float32))
    per_gate = tupd.SepConvGRU(16, 24)
    fused = tupd.SepConvGRU(16, 24, use_kernel=True)
    fused.load_state_dict(per_gate.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(fused(h, x).numpy(), per_gate(h, x).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags", [dict(pallas_stem=True),
                                   dict(pallas_conv=True),
                                   dict(lookup_method="pallas_q8",
                                        pallas_stem=True, pallas_conv=True)])
def test_state_dict_keys_unchanged_by_flags(flags):
    _, base = configs(**BF16)
    _, opt = configs(**BF16, **flags)
    a = bt.build_model(base, device="cpu").state_dict()
    b = bt.build_model(opt, device="cpu").state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


def test_launch_derivation_matches_dispatch(monkeypatch):
    """chip_smoke.expected_launches (from the copied gates) equals the
    model's dispatch, counted at the wrappers, at a small shape whose
    gates differ from the flagship's."""
    import chip_smoke

    kw = dict(lookup_method="pallas_q8", pallas_stem=True, pallas_conv=True,
              iters_test=2, **BF16)
    _, tcfg = configs(**kw)
    model = bt.build_model(tcfg, device="cpu")
    voxel, images = make_inputs(tcfg, H=144, W=64, seed=3)
    calls = _Calls(monkeypatch)
    tables = []
    fwd = klookup._pyramid_fwd

    def lookup(table, *args):
        tables.append([lv.vol.dtype for lv in table])
        return fwd(table, *args)

    monkeypatch.setattr(klookup, "_pyramid_fwd", lookup)
    model(torch.from_numpy(voxel), torch.from_numpy(images), test_mode=True)
    want = chip_smoke.expected_launches(tcfg, 1, 144, 64, 2)
    assert calls.counts() == {kconv.NAME: want[kconv.NAME],
                              kstem.NAME: want[kstem.NAME]}
    assert want[kstem.NAME] == 9 and want[kconv.NAME] > 30
    # one all-level lookup per iteration, the int8 level 0 (18 rows) in
    # its table
    assert len(tables) == want[klookup.NAME] == 2
    assert all(t == [torch.int8] + [torch.bfloat16] * 3 for t in tables)


def test_opt_in_forward_matches_jax(interpret):
    """The full opt-in forward (q8 lookup, stem and conv kernels, bf16,
    fused convc1) against the JAX model with the same switches, 144x64
    (level 0 has 18 rows: quantized), one iteration, damped head. Bound
    5e-2 relative, the bf16 bound of tests/test_precision_modes.py: bf16
    flips through three encoders, int8 roundings of the volume and the
    update block."""
    kw = dict(lookup_method="pallas_q8", pallas_stem=True, pallas_conv=True,
              fuse_corr_conv=True, iters_test=1, **BF16)
    jcfg, tcfg = configs(**kw)
    voxel, images = make_inputs(jcfg, H=144, W=64, seed=6)
    model = JaxRAFTSpline(jcfg)
    variables = damp_head(random_variables(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(voxel),
                           jnp.asarray(images), test_mode=True), 7))

    @jax.jit
    def run(v, voxel, images):
        return model.apply(v, voxel, images, test_mode=True)[1].params

    want = np.asarray(run(variables, jnp.asarray(voxel), jnp.asarray(images)))
    port = load_jax_variables(bt.build_model(tcfg, device="cpu"), variables)
    _, up = port(torch.from_numpy(voxel), torch.from_numpy(images),
                 test_mode=True)
    assert up.params.shape == want.shape == (1, 144, 64, 2, 2)
    assert np.isfinite(up.params.numpy()).all()
    assert rel_err(up.params.numpy(), want) < 5e-2
