"""Port parity: the whole RAFT-Spline test_mode forward against the JAX
model, same weights (numpy-drawn) and inputs (64x64, 5 bins).

Bounds, as relative max errors of the Bezier parameters:
  * f32 vs JAX (lookup 'gather'), 2 iterations: < 1e-4;
  * f32 vs JAX, 12 iterations with the damped head: < 1e-3 (random-init
    recurrences amplify f32 round-off; ROADMAP Queue 3);
  * the port's bf16 vs its own f32 at 12 iterations, damped head: < 5e-2,
    the bound of tests/test_precision_modes.py.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu.models import RAFTSpline as JaxRAFTSpline
from bflow_tpu.models import corr as jcorr
from bflow_tpu.ops import BezierCurves as JaxBezier
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    configs,
    damp_head,
    make_inputs,
    random_variables,
    rel_err,
)


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = configs()
    voxel, images = make_inputs(jcfg, seed=0)
    model = JaxRAFTSpline(jcfg)
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(voxel),
                           jnp.asarray(images), test_mode=True), 1)
    damped = damp_head(copy.deepcopy(variables))
    return variables, damped, voxel, images


def _jax_forward(variables, voxel, images, flow_init=None, **cfg_kw):
    """The JAX test_mode forward, jitted (one compile is several times
    quicker than op-by-op dispatch of the unrolled iterations)."""
    jcfg, _ = configs(**cfg_kw)
    model = JaxRAFTSpline(jcfg)

    @jax.jit
    def run(variables, voxel, images, init):
        init = None if init is None else JaxBezier(init)
        low, up = model.apply(variables, voxel, images, flow_init=init,
                              test_mode=True)
        return low.params, up.params

    init = None if flow_init is None else jnp.asarray(flow_init)
    images = None if images is None else jnp.asarray(images)
    low, up = run(variables, jnp.asarray(voxel), images, init)
    return np.asarray(low), np.asarray(up)


def _port_model(variables, **cfg_kw):
    _, tcfg = configs(**cfg_kw)
    model = bt.build_model(tcfg, device="cpu")
    return load_jax_variables(model, variables)


def _port_forward(variables, voxel, images, flow_init=None, **cfg_kw):
    model = _port_model(variables, **cfg_kw)
    init = None if flow_init is None else bt.BezierCurves(
        torch.from_numpy(flow_init))
    images = None if images is None else torch.from_numpy(images)
    low, up = model(torch.from_numpy(voxel), images, flow_init=init,
                    test_mode=True)
    return low, up


@pytest.mark.parametrize("fuse", [True, False])
def test_forward_f32_matches_jax_2_iters(setup, fuse):
    variables, _, voxel, images = setup
    want_low, want_up = _jax_forward(variables, voxel, images,
                                     fuse_corr_conv=fuse)
    low, up = _port_forward(variables, voxel, images, fuse_corr_conv=fuse)
    assert tuple(up.params.shape) == want_up.shape == (1, 64, 64, 2, 2)
    assert tuple(low.params.shape) == want_low.shape == (1, 8, 8, 2, 2)
    assert rel_err(low.params.numpy(), want_low) < 1e-4
    assert rel_err(up.params.numpy(), want_up) < 1e-4


@pytest.fixture(scope="module")
def twelve_iters(setup):
    """The port's f32 and bf16 12-iteration forwards (damped head) and
    the JAX f32 one."""
    _, damped, voxel, images = setup
    kw = dict(fuse_corr_conv=True, iters_test=12)
    want = _jax_forward(damped, voxel, images, **kw)
    f32 = _port_forward(damped, voxel, images, **kw)
    bf16 = _port_forward(damped, voxel, images, corr_precision="bfloat16",
                         compute_dtype="bfloat16", **kw)
    return want, f32, bf16


def test_forward_f32_matches_jax_12_iters_damped(twelve_iters):
    (want_low, want_up), (low, up), _ = twelve_iters
    assert rel_err(low.params.numpy(), want_low) < 1e-3
    assert rel_err(up.params.numpy(), want_up) < 1e-3


@pytest.mark.parametrize("t", [0.5, 1.0])
def test_bf16_bounded_vs_f32_12_iters_damped(twelve_iters, t):
    _, (_, up32), (_, up16) = twelve_iters
    assert up16.params.dtype == torch.float32  # Bezier state stays f32
    f16 = up16.flow_at(t).numpy()
    assert np.isfinite(f16).all()
    assert rel_err(f16, up32.flow_at(t).numpy()) < 5e-2


def test_flow_init_matches_jax(setup):
    _, damped, voxel, images = setup
    init = np.full((1, 8, 8, 2, 2), 3.0, np.float32)
    want_low, _ = _jax_forward(damped, voxel, images, flow_init=init)
    low, _ = _port_forward(damped, voxel, images, flow_init=init)
    assert rel_err(low.params.numpy(), want_low) < 1e-4
    plain, _ = _port_forward(damped, voxel, images)
    assert not np.allclose(plain.params.numpy(), low.params.numpy())


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_kernel_methods_take_plain_lookup_on_cpu(setup, method):
    """On CPU tensors the kernel wrapper runs its plain version: the
    'auto'/'pallas' forward equals the 'gather' one bit for bit."""
    variables, _, voxel, images = setup
    _, a = _port_forward(variables, voxel, images, lookup_method=method)
    _, b = _port_forward(variables, voxel, images, lookup_method="gather")
    assert torch.equal(a.params, b.params)


# every opt-in override of the JAX config, with what it needs to take
# effect: the mixed one-hot dispatch a kernel lookup method, the conv
# kernels' gates the bf16 mode, the q8 gate a level-0 map of >= 17 rows
# (H >= 136). Bounds, on the low-res and upsampled Bezier parameters:
# f32 paths 1e-4 (summation order); q8 in f32 compute 2e-2 (its quantized
# levels' lookups are bf16 on both sides, a few ulps apart:
# tests/test_torch_corr_q8.py; measured 1.1e-2). The bf16 conv modes are
# held on the upsampled flow at t = 0.5 and 1 to 5e-2, the bf16 bound of
# tests/test_precision_modes.py: bf16 roundings of the two packages part
# at many places (without any kernel, the port's bf16 forward is 1.5e-2
# from JAX's on the upsampled and 3.8e-2 on the small low-res parameters).
BF16 = dict(compute_dtype="bfloat16", corr_precision="bfloat16")
OPT_IN = [
    (dict(lookup_method="onehot"), {}, 64, 1e-4),
    (dict(lookup_method="pallas_q8"), {}, 144, 2e-2),
    (dict(onehot_from_level=2), dict(lookup_method="pallas"), 64, 1e-4),
    (dict(scan_iters=True), {}, 64, 1e-4),
    (dict(onehot_from_level=0), dict(lookup_method="pallas"), 64, 1e-4),
    (dict(pallas_stem=True), dict(iters_test=1, **BF16), 64, 5e-2),
    (dict(pallas_conv=True), dict(iters_test=1, **BF16), 64, 5e-2),
]


@pytest.mark.parametrize(
    "override,base,H,bound", OPT_IN,
    ids=["-".join(f"{k}={v}" for k, v in o.items()) for o, *_ in OPT_IN])
def test_opt_in_override_matches_jax(setup, override, base, H, bound,
                                     monkeypatch):
    """Each option the port used to refuse, against the JAX forward with
    the same option, its Pallas kernels in interpret mode, damped head."""
    monkeypatch.setenv("BFLOW_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jcorr, "_INTERPRET", True)
    _, damped, _, _ = setup
    kw = {**base, **override}
    jcfg, _ = configs(**kw)
    voxel, images = make_inputs(jcfg, H=H, W=64, seed=0)
    want_low, want_up = _jax_forward(damped, voxel, images, **kw)
    low, up = _port_forward(damped, voxel, images, **kw)
    assert tuple(up.params.shape) == want_up.shape == (1, H, 64, 2, 2)
    if kw.get("compute_dtype") == "bfloat16":
        want = JaxBezier(jnp.asarray(want_up))
        for t in (0.5, 1.0):
            assert rel_err(up.flow_at(t).numpy(),
                           np.asarray(want.flow_at(t))) < bound, t
    else:
        assert rel_err(low.params.numpy(), want_low) < bound
        assert rel_err(up.params.numpy(), want_up) < bound


def test_scan_iters_equals_the_loop_bitwise(setup):
    """scan_iters only changes JAX's compile time; the port runs the same
    eager loop, so the outputs are equal bit for bit."""
    _, damped, voxel, images = setup
    _, a = _port_forward(damped, voxel, images, iters_test=3)
    _, b = _port_forward(damped, voxel, images, iters_test=3,
                         scan_iters=True)
    assert torch.equal(a.params, b.params)


def test_pallas_q8_raises_under_autograd(setup):
    """The int8 lookup has no gradient (nor has the JAX one): a forward
    that records a graph is refused with a clear error; test_mode and
    no_grad forwards run."""
    variables, _, voxel, images = setup
    model = _port_model(variables, lookup_method="pallas_q8")
    v, i = torch.from_numpy(voxel), torch.from_numpy(images)
    with pytest.raises(RuntimeError, match="inference only"):
        model(v, i)
    with torch.no_grad():
        preds = model(v, i)
    _, up = model(v, i, test_mode=True)
    assert torch.equal(preds[-1].params, up.params)


def test_train_forward_not_ported(setup):
    """The training forward is ported now (the name is the one this test
    had while it raised): test_mode=False returns every iteration's
    upsampled curves, with a graph for the loss; the last one is the
    test_mode prediction (eval mode: both read the running BatchNorm
    statistics)."""
    variables, _, voxel, images = setup
    model = _port_model(variables)
    preds = model(torch.from_numpy(voxel), torch.from_numpy(images))
    assert len(preds) == model.config.iters_train == 2
    assert all(tuple(p.params.shape) == (1, 64, 64, 2, 2) for p in preds)
    assert preds[-1].params.requires_grad
    _, up = model(torch.from_numpy(voxel), torch.from_numpy(images),
                  test_mode=True)
    assert not up.params.requires_grad
    assert torch.equal(preds[-1].params.detach(), up.params)
    assert not torch.equal(preds[0].params, preds[1].params)


def test_remat_updates_is_ported(setup):
    """remat_updates builds, and its forward equals the plain one (the
    gradients are held equal in tests/test_torch_train.py)."""
    variables, _, voxel, images = setup
    plain = _port_model(variables)
    remat = _port_model(variables, remat_updates=True)
    a = plain(torch.from_numpy(voxel), torch.from_numpy(images))
    b = remat(torch.from_numpy(voxel), torch.from_numpy(images))
    assert all(torch.equal(x.params, y.params) for x, y in zip(a, b))


def test_build_model_is_seeded():
    _, tcfg = configs()
    a = bt.build_model(tcfg, device="cpu", seed=3).state_dict()
    b = bt.build_model(tcfg, device="cpu", seed=3).state_dict()
    c = bt.build_model(tcfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet_ev.conv1.weight"],
                           c["fnet_ev.conv1.weight"])
    assert not bt.build_model(tcfg, device="cpu").training


def test_events_only_forward_matches_jax():
    """The events-only family (no frame target, no image encoder)."""
    kw = dict(use_images=False, iters_test=1)
    jcfg, _ = configs(**kw)
    voxel, _ = make_inputs(jcfg, H=32, W=48, seed=2)
    model = JaxRAFTSpline(jcfg)
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(voxel), None,
                           test_mode=True), 5)
    _, want_up = _jax_forward(variables, voxel, None, **kw)
    _, up = _port_forward(variables, voxel, None, **kw)
    assert not hasattr(_port_model(variables, **kw), "fnet_img")
    assert rel_err(up.params.numpy(), want_up) < 1e-4
