"""Guards of the port: it imports no JAX and nothing of bflow_tpu, its
entry points refuse to fall back to the CPU, its weights bridge round-trips
through the JAX package's importer, and (on a GPU only) its CUDA kernels
match their plain versions at the flagship shapes (the all-level lookup
forward and accumulating backward too; the forward also over pallas_q8's
int8 levels, and on ragged shapes), the conv kernels in every tile
variant, an encoder under the conv kernels stays channels-last between
convs, the sink hands the kernels' dVol to autograd, a model launches
one all-level lookup per iteration each way, and an eval step and a train
step make no synchronising call (on the CPU: every Bezier coefficient
comes from the cache).

JAX is imported inside the tests that use it, so that the GPU tests run on
a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_guards.py
"""

from __future__ import annotations

import ast
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu_torch.weights import state_dict_from_jax
from test_torch_common import configs, make_inputs, random_variables
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bflow_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_package_imports_no_jax():
    """Import the package and every submodule in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in %r)\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was imported


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  *sorted(str(p.relative_to(ROOT)) for p in
                                          (ROOT / "bflow_tpu_torch")
                                          .rglob("*.py"))])
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(ROOT / path) if _forbidden(m)]
    assert not bad, (path, bad)


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = bt.RaftSplineConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.build_model(cfg, device="cuda:0")
    assert next(bt.build_model(cfg, device="cpu").parameters()).is_cpu


@pytest.fixture(scope="module")
def jax_variables():
    import jax
    import jax.numpy as jnp

    from bflow_tpu.models import RAFTSpline as JaxRAFTSpline

    jcfg, tcfg = configs()
    voxel, images = make_inputs(jcfg, H=32, W=32)
    model = JaxRAFTSpline(jcfg)
    init = lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(voxel),
                              jnp.asarray(images), test_mode=True)
    return random_variables(init, 3), jax.eval_shape(init), tcfg


def test_weights_round_trip_through_importer(jax_variables):
    """state_dict_from_jax and the JAX package's importer are inverses,
    batch statistics included."""
    import jax

    from bflow_tpu.importer.torch_ckpt import convert_state_dict

    variables, template, _ = jax_variables
    sd = state_dict_from_jax(variables)
    back = convert_state_dict({"net." + k: v for k, v in sd.items()},
                              template)
    flat_v = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b) > 100
    for path, value in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), value,
                                      err_msg=str(path))
    assert "batch_stats" in back and back["batch_stats"]


def test_weights_match_port_state_dict(jax_variables):
    variables, _, tcfg = jax_variables
    model = bt.build_model(tcfg, device="cpu")
    sd = state_dict_from_jax(variables, model.state_dict())
    assert set(sd) == set(model.state_dict())
    for k in ("fnet_ev.layer2.0.downsample.0.weight",
              "cnet.norm1.running_mean", "update_block.gru.convz1.weight",
              "update_block.mask.2.bias"):
        assert k in sd, k
    w = variables["params"]["fnet_ev"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["fnet_ev.conv1.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_weights_export_inverts_the_bridge(jax_variables):
    """jax_variables_from_state_dict undoes state_dict_from_jax, batch
    statistics included (the train tests read mutated statistics back
    out this way)."""
    import jax

    from bflow_tpu_torch.weights import jax_variables_from_state_dict

    variables, _, _ = jax_variables
    back = jax_variables_from_state_dict(state_dict_from_jax(variables))
    flat_v = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, value in flat_v:
        np.testing.assert_array_equal(flat_b[path], value, err_msg=str(path))


@pytest.mark.parametrize("fault", ["unknown_leaf", "missing", "shape",
                                   "stray_collection"])
def test_weights_bridge_is_strict(jax_variables, fault):
    variables, _, tcfg = jax_variables
    v = copy.deepcopy(variables)
    with torch.device("meta"):  # shapes only
        target = bt.RAFTSpline(tcfg).state_dict()
    conv1 = v["params"]["fnet_ev"]["conv1"]
    if fault == "unknown_leaf":
        conv1["gamma"] = conv1["bias"]
    elif fault == "missing":
        del v["params"]["update_block"]["gru"]["convz1"]
    elif fault == "shape":
        conv1["kernel"] = conv1["kernel"][:, :, :2]
    else:
        v["cache"] = {}
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(v, target)


# ---------------------------------------------------------------------------
# on the GPU only: the kernel against its plain version (chip_smoke phase 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lookup kernel is CUDA C++ "
                    "with no CPU mode; its plain version is tested above")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", range(4))
def test_lookup_kernel_matches_plain_on_gpu(cuda_device, dtype, level):
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    Tl, hl, wl = chip_smoke.LEVELS[level]
    before = corr_lookup.launches
    rec = chip_smoke.check_lookup_level(Tl, hl, wl, dtype, seed=level)
    assert corr_lookup.launches == before + 1
    assert rec["ok"], rec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", range(4))
def test_lookup_bwd_kernel_matches_plain_on_gpu(cuda_device, dtype, level):
    """The backward kernel against its plain twin at the flagship level
    shapes, twice, bitwise repeatable (chip_smoke's backward phase)."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    Tl, hl, wl = chip_smoke.LEVELS[level]
    before = corr_lookup.bwd_launches
    rec = chip_smoke.check_lookup_bwd_level(Tl, hl, wl, dtype, seed=level)
    assert corr_lookup.bwd_launches == before + 2
    assert rec["ok"], rec


@pytest.mark.cuda
@pytest.mark.parametrize("vol_grad", [True, False])
def test_lookup_kernel_gradients_on_gpu(cuda_device, vol_grad):
    """Autograd through the CUDA lookup runs the backward kernel once and
    gives the twin's VJP; a volume that needs no gradient gets none."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    vol, coords = chip_smoke.level_inputs(2, 15, 20, torch.float32, seed=5)
    vol.requires_grad_(vol_grad)
    coords.requires_grad_(True)
    g = torch.randn(vol.shape[0], 81, device=cuda_device)
    before = corr_lookup.bwd_launches
    out = corr_lookup.corr_lookup_level(vol, coords, 4)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert corr_lookup.bwd_launches == before + 1
    want_v, want_c = corr_lookup.corr_lookup_level_bwd_plain(
        vol.detach(), coords.detach(), g, 4)
    assert (coords.grad - want_c).abs().max() <= 1e-4 * want_c.abs().max()
    if vol_grad:
        assert (vol.grad - want_v).abs().max() <= 1e-5 * want_v.abs().max()
    else:
        assert vol.grad is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_pyramid_kernel_matches_plain_on_gpu(cuda_device, dtype):
    """The all-level forward kernel, one launch for the flagship's four
    levels, equals its plain twin exactly, and each level's channels
    equal the one-level entry (chip_smoke phase 3)."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    before = corr_lookup.launches
    rec = chip_smoke.check_lookup_pyramid(1, chip_smoke.H1, chip_smoke.W1,
                                          dtype, seed=0, timing=False)
    assert corr_lookup.launches == before + 1 + len(chip_smoke.LEVELS)
    assert rec["ok"] and rec["max_abs_err"] == 0.0, rec


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", ["flagship", "train"])
def test_lookup_pyramid_bwd_accumulates_on_gpu(cuda_device, shapes):
    """The all-level backward kernel: 12 iterations into one f32 dVol
    buffer per level, twice, bitwise equal, within BWD_TOL of the
    accumulating twin (chip_smoke phase 3b): flagship bf16, training
    f32."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    n, h1, w1, dtype = ((1, chip_smoke.H1, chip_smoke.W1, torch.bfloat16)
                        if shapes == "flagship" else
                        (chip_smoke.TRAIN_B, chip_smoke.TRAIN_H // 8,
                         chip_smoke.TRAIN_W // 8, torch.float32))
    before = corr_lookup.bwd_launches
    rec = chip_smoke.check_lookup_pyramid_bwd(n, h1, w1, dtype, seed=1,
                                              timing=False)
    assert corr_lookup.bwd_launches == before + 2 * chip_smoke.ITERS
    assert rec["ok"] and rec["bitwise_repeatable"], rec


@pytest.mark.cuda
def test_sink_gradients_on_gpu(cuda_device):
    """Three lookups of one pyramid through the kernels and the sink:
    the features' and coords' gradients against the same graph through
    the plain twins on the card; a retained graph gives the same
    gradients twice; a coords-only gradient leaves no accumulator."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup
    from bflow_tpu_torch.models import corr as tcorr

    gen = torch.Generator(device="cuda").manual_seed(7)
    ref = torch.randn(5, 1, 16, 24, 32, generator=gen, device="cuda")
    tgt = torch.randn(5, 1, 16, 24, 32, generator=gen, device="cuda")
    base = 20 * torch.rand(5, 1, 16, 24, 2, generator=gen, device="cuda")
    ws = [torch.randn(1, 16, 24, 11 * 81, generator=gen, device="cuda")
          for _ in range(3)]

    def graph():
        leaves = [t.clone().requires_grad_(True) for t in (ref, tgt, base)]
        pyr = tcorr.build_corr_pyramid(leaves[0], leaves[1],
                                       (1, 1, 1, 4, 4))
        loss = sum((tcorr.corr_lookup(pyr, leaves[2] * (1 + 0.1 * i), 4,
                                      "pallas") * w).sum()
                   for i, w in enumerate(ws))
        return loss, leaves, pyr

    before = (corr_lookup.launches, corr_lookup.bwd_launches)
    loss, leaves, pyr = graph()
    (dc,) = torch.autograd.grad(loss, leaves[2], retain_graph=True)
    assert pyr.sink._acc._bufs is None
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    again = torch.autograd.grad(loss, leaves)
    assert (corr_lookup.launches, corr_lookup.bwd_launches) == (
        before[0] + 3, before[1] + 9)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(dc, got[2])
    with chip_smoke.plain_twins():
        loss_p, leaves_p, _ = graph()
        want = torch.autograd.grad(loss_p, leaves_p)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        assert (g - w).abs().max() <= tol * w.abs().max()


# the released families' shapes (benchmark/configs/), at 64x64 and two
# iterations: DSEC degree 2 over targets (1, 2, 3, 4) at depths (1, 1, 1,
# 4); MultiFlow degree 10 over (8, ..., 40) at (1, 1, 1, 1, 4) with the
# multi-loss at ten supervision times
FAMILIES = {
    "dsec": (dict(nbins_context=15, nbins_correlation=15, bezier_degree=2),
             {}),
    "multiflow2d": (dict(nbins_context=41, nbins_correlation=25,
                         bezier_degree=10,
                         ev_target_indices=(8, 16, 24, 32, 40),
                         ev_levels=(1, 1, 1, 1, 4)),
                    dict(multi_loss=True, supervision_timestamps=tuple(
                        i / 10 for i in range(1, 11)))),
}


def _family_steps(family, device):
    """(eval_step, train_step, batch) of a small model of the family on
    ``device``, one warm-up call of each made."""
    from bflow_tpu_torch.train import (TaskConfig, TrainState,
                                       make_eval_step, make_train_step)

    fields, task_kw = FAMILIES[family]
    cfg = bt.RaftSplineConfig(iters_train=2, iters_test=2,
                              fuse_corr_conv=True, **fields)
    task = TaskConfig(family, **task_kw)
    model = bt.build_model(cfg, device=device, seed=0)
    state = TrainState.create(model, {
        "learning_rate": 1e-4, "weight_decay": 1e-4, "gradient_clip_val": 1,
        "lr_scheduler": {"use": True, "total_steps": 1000,
                         "pct_start": 0.01}})
    train_step = make_train_step(model, task, state.optimizer,
                                 state.scheduler)
    eval_step = make_eval_step(model, task)
    rng = np.random.default_rng(0)
    n, h, w = 1, 64, 64
    flow = (n, h, w, 2) if family == "dsec" else (10, n, h, w, 2)
    batch = {"ev_repr": rng.standard_normal((n, h, w, cfg.nbins_total)),
             "img": rng.integers(0, 255, (2, n, h, w, 3)),
             "flow": 3.0 * rng.standard_normal(flow),
             "flow_valid": rng.random((n, h, w)) < 0.8}
    batch = {k: torch.from_numpy(v.astype(bool if k == "flow_valid"
                                          else np.float32)).to(device)
             for k, v in batch.items()}
    eval_step(batch)
    train_step(batch)
    return eval_step, train_step, batch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_steps_take_every_bezier_coefficient_from_the_cache(family):
    """After one warm-up call of each, an eval step and a train step make
    no new coefficient vector: every flow_at call hits the cache."""
    from bflow_tpu_torch.ops import bezier

    eval_step, train_step, batch = _family_steps(family, "cpu")
    bezier.reset_counters()
    eval_step(batch)
    train_step(batch)
    assert bezier.coeff_misses == 0 and bezier.coeff_hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_steps_make_no_synchronising_call_on_gpu(cuda_device, family):
    """After one warm-up call of each, an eval step and a train step run
    under torch.cuda.set_sync_debug_mode("error") without raising: the
    host never waits for the card inside a step (flow_at's coefficients
    come from the device cache, the pyramid picks its levels' targets
    without index tensors), and no coefficient is copied anew."""
    from bflow_tpu_torch.ops import bezier

    eval_step, train_step, batch = _family_steps(family, cuda_device)
    torch.cuda.synchronize()
    bezier.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eval_step(batch)
        train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bezier.coeff_misses == 0 and bezier.coeff_hits > 0


@pytest.mark.cuda
def test_model_launch_counts_on_gpu(cuda_device):
    """One all-level lookup launch per iteration: a flagship-config
    forward (default and opt-in modes) and a train-mode forward and
    backward, at 64x96 and 2 iterations, launch what expected_launches
    derives. The inference forwards (test_mode: under torch.no_grad) take
    the norm kernel at each of their 45 norms, the training forward at
    none."""
    import dataclasses

    import chip_smoke

    from bflow_tpu_torch import kernels
    from bflow_tpu_torch.kernels import corr_lookup

    rng = np.random.default_rng(0)
    cfg = bt.flagship_config()
    voxel = torch.from_numpy(rng.standard_normal(
        (1, 64, 96, cfg.nbins_total)).astype(np.float32)).to(cuda_device)
    images = torch.from_numpy(rng.integers(0, 255, (2, 1, 64, 96, 3)).astype(
        np.float32)).to(cuda_device)
    for c in (cfg, chip_smoke.opt_in_config()):
        model = bt.build_model(c, device="cuda")
        kernels.reset_launch_counts()
        model(voxel, images, iters=2, test_mode=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == chip_smoke.expected_launches(
            c, 1, 64, 96, 2)
    model = bt.build_model(dataclasses.replace(cfg, iters_train=2),
                           device="cuda").train()
    kernels.reset_launch_counts()
    preds = model(voxel, images, test_mode=False)
    sum(p.params.float().sum() for p in preds).backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts[corr_lookup.NAME] == counts[corr_lookup.BWD_NAME] == 2
    assert counts == chip_smoke.expected_launches(
        model.config, 1, 64, 96, 2, train=True) | {
            corr_lookup.BWD_NAME: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(2))
def test_q8_lookup_kernel_matches_plain_on_gpu(cuda_device, level):
    """The one-level int8 entry (the forward kernel with a one-level int8
    table) against its twin at the two flagship levels that pallas_q8
    quantizes (chip_smoke phase 3c)."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    Tl, hl, wl = chip_smoke.LEVELS[level]
    before = corr_lookup.launches
    rec = chip_smoke.check_q8_level(Tl, hl, wl, seed=level)
    assert corr_lookup.launches == before + 1
    assert rec["ok"] and rec["max_abs_err"] == 0.0, rec


def _ragged_q8_table(rest, radius, device):
    """A table on ragged shapes (2 images of 5 x 7 queries, 3 base
    targets): int8 levels of 9 x 13 and 5 x 3 maps beside `rest` levels
    of 0 x 4 (no rows) and 2 x 1 maps (rest None: the int8 levels alone);
    base coords around the maps, one in five far (+-1e4), one in five just
    below an integer."""
    from bflow_tpu_torch.kernels import corr_lookup

    gen = torch.Generator(device=device).manual_seed(17 + radius)
    n, h1, w1 = 2, 5, 7
    spec = [((0, 1, 2), 9, 13, True), ((1, 2), 5, 3, True)]
    if rest is not None:
        spec += [((2,), 0, 4, False), ((0, 2), 2, 1, False)]
    table = []
    for lvl, (idx, hl, wl, q8) in enumerate(spec):
        vol = torch.randn(len(idx), n, h1, w1, hl, wl, generator=gen,
                          device=device)
        if q8:
            vq, scale = corr_lookup.quantize_volume(vol.bfloat16())
            table.append(corr_lookup.TableLevel(vq, idx, lvl, scale))
        else:
            table.append(corr_lookup.TableLevel(vol.to(rest), idx, lvl))
    c = torch.rand(3, n, h1, w1, 2, generator=gen, device=device) * 18 - 3
    pick = torch.rand(3, n, h1, w1, 1, generator=gen, device=device)
    far = torch.where(torch.rand(3, n, h1, w1, 2, generator=gen,
                                 device=device) < 0.5, -1e4, 1e4)
    below = torch.nextafter(torch.round(c), torch.full_like(c, -1e9))
    c = torch.where(pick < 0.2, far, torch.where(pick > 0.8, below, c))
    return table, c.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("rest", [torch.bfloat16, torch.float32, None])
def test_q8_table_matches_plain_on_ragged_shapes_on_gpu(cuda_device, rest,
                                                        radius):
    """The all-level forward over int8 levels beside bf16 or f32 levels
    (one of them with no rows), or over int8 levels alone, equals its
    plain twin bit for bit in the promoted output type, on ragged shapes
    with far coordinates and coordinates at the rounding edge, in one
    launch."""
    from bflow_tpu_torch.kernels import corr_lookup

    table, c = _ragged_q8_table(rest, radius, cuda_device)
    before = corr_lookup.launches
    got = corr_lookup.lookup_pyramid_cuda(table, c, radius)
    torch.cuda.synchronize()
    assert corr_lookup.launches == before + 1
    want = corr_lookup.corr_lookup_pyramid_plain(table, c, radius)
    assert got.dtype == want.dtype == (rest or torch.bfloat16)
    assert torch.equal(got, want)
    assert want.abs().max() > 0


@pytest.mark.cuda
def test_bf16_table_unchanged_beside_int8_on_gpu(cuda_device):
    """At the flagship shapes the bf16 table equals its twin bit for bit,
    the opt-in table's bf16 levels 2-3 give the bf16 table's bits, and
    chip_smoke's phase 3c checks pass: the opt-in table and its int8
    levels alone exact against their twins and, per level, against the
    one-level entries (one launch each)."""
    import chip_smoke

    from bflow_tpu_torch.kernels import corr_lookup

    table, coords = chip_smoke.pyramid_inputs(1, chip_smoke.H1,
                                              chip_smoke.W1, torch.bfloat16,
                                              seed=3)
    mixed = chip_smoke.q8_table(table)
    assert [lv.vol.dtype for lv in mixed] == [torch.int8] * 2 + [
        torch.bfloat16] * 2
    plain = corr_lookup.lookup_pyramid_cuda(table, coords, 4)
    both = corr_lookup.lookup_pyramid_cuda(mixed, coords, 4)
    torch.cuda.synchronize()
    assert torch.equal(plain, corr_lookup.corr_lookup_pyramid_plain(
        table, coords, 4))
    deep = (5 + 2) * 81  # channels of levels 0-1
    assert torch.equal(both[..., deep:], plain[..., deep:])
    before = corr_lookup.launches
    rec_mixed, rec_q8 = chip_smoke.check_q8_pyramid(
        1, chip_smoke.H1, chip_smoke.W1, seed=4, timing=False)
    assert corr_lookup.launches == before + (1 + 4) + (1 + 2)
    for rec in (rec_mixed, rec_q8):
        assert rec["ok"] and rec["max_abs_err"] == 0.0, rec


@pytest.mark.cuda
def test_lookup_kernels_refuse_tables_they_do_not_take_on_gpu(cuda_device):
    """The backward kernel returns cudaErrorInvalidValue for a table with
    an int8 level (its wrapper raises before any launch), and the forward
    for a table whose unquantized levels are not of its output type."""
    import ctypes

    from bflow_tpu_torch.kernels import build, corr_lookup

    table, c = _ragged_q8_table(torch.bfloat16, 4, cuda_device)
    C = sum(len(lv.targets) for lv in table) * 81
    g = torch.zeros(*c.shape[1:4], C, device=cuda_device,
                    dtype=torch.bfloat16)
    dc = torch.empty_like(c)
    tab = corr_lookup._table_struct(table, c, 4, C)
    stream = torch.cuda.current_stream().cuda_stream
    bwd = build.function(corr_lookup.BWD_NAME, "corr_lookup_bwd_bf16",
                         corr_lookup._ARGTYPES[corr_lookup.BWD_NAME])
    assert bwd(ctypes.byref(tab), c.data_ptr(), g.data_ptr(), dc.data_ptr(),
               stream) == 1  # cudaErrorInvalidValue
    fwd = build.function(corr_lookup.NAME, "corr_lookup_fwd_f32",
                         corr_lookup._ARGTYPES[corr_lookup.NAME])
    out = torch.empty(*c.shape[1:4], C, device=cuda_device)
    assert fwd(ctypes.byref(tab), c.data_ptr(), out.data_ptr(), stream) == 1
    before = corr_lookup.bwd_launches
    with pytest.raises(ValueError, match="no backward"):
        corr_lookup.lookup_pyramid_bwd_cuda(table, c, g, 4, None)
    assert corr_lookup.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["conv3x3", "stem_conv"])
def test_conv_kernels_match_plain_on_gpu(cuda_device, kernel):
    """Each conv kernel against its twin on channels-last and
    NCHW-contiguous inputs, the wrapper's layout copies and prepared
    weights, and its gradients against the plain formulation's, at every
    flagship shape the gates send to it (chip_smoke phase 3c)."""
    import dataclasses

    import chip_smoke

    from bflow_tpu_torch import kernels

    cfg = dataclasses.replace(bt.flagship_config(), pallas_stem=True,
                              pallas_conv=True)
    rows = [r for r in chip_smoke.flagship_convs(cfg)
            if r["kernel"] == kernel]
    assert len(rows) == {"conv3x3": 17, "stem_conv": 9}[kernel]
    for i, row in enumerate(rows):
        before = kernels.launch_counts()[kernel]
        rec = chip_smoke.check_conv(row, seed=i, timing=False)
        # channels-last x, NCHW x, the repeat, the doubled weight, grads
        assert kernels.launch_counts()[kernel] == before + 5
        assert rec["ok"], rec


# ragged in M (pixels past the last tile), O (channels past the last
# channel tile, odd O: 2-byte stores) and K (the last K step part empty, C
# padded from 4 and 12 to 8 and 16)
RAGGED_CONVS = [((1, 8, 9, 13), 64, 3, 3), ((2, 4, 11, 7), 124, 7, 7),
                ((1, 64, 17, 19), 96, 3, 3), ((1, 136, 10, 12), 200, 1, 5),
                ((3, 12, 7, 5), 33, 5, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,o,kh,kw", RAGGED_CONVS)
def test_conv_kernels_every_tile_plan_on_gpu(cuda_device, shape, o, kh, kw,
                                             stride):
    """Every tile variant the kernels are built for, forced on ragged
    shapes, on channels-last, NCHW-contiguous and sliced inputs: the same
    bits from each layout, within one bf16 ulp of the twin, channels-last
    out."""
    from bflow_tpu_torch.kernels import conv3x3, conv_common, stem_conv

    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + o)
    n, c, h, w = shape
    big = torch.randn(n, c + 3, h, w + 2, generator=gen,
                      device="cuda").bfloat16()
    sliced = big[:, 1:c + 1, :, 2:]
    x = sliced.contiguous()
    x_cl = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(o, c, kh, kw, generator=gen,
                     device="cuda") / (c * kh * kw) ** 0.5
    b = 0.1 * torch.randn(o, generator=gen, device="cuda")
    want = conv_common.conv_plain(x, wt, b, stride, True).float()
    plans = conv_common.all_plans()
    assert len(plans) == 18 and all(p.legal() for p in plans)
    for plan in plans:
        if stride == 1:
            outs = [conv3x3.conv2d(t, wt, b, True, plan=plan)
                    for t in (x_cl, x, sliced)]
        else:
            outs = [torch.relu(stem_conv.stem_conv(t, wt, b, plan=plan))
                    for t in (x_cl, x, sliced)]
        torch.cuda.synchronize()
        assert all(t.is_contiguous(memory_format=torch.channels_last)
                   for t in outs), plan
        assert torch.equal(outs[0], outs[1]), plan
        assert torch.equal(outs[0], outs[2]), plan
        err = (outs[0].float() - want).abs().max() / want.abs().max()
        assert err <= 1e-2, (plan, err.item())


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["instance", "batch", "group", "none"])
def test_encoder_keeps_channels_last_between_convs_on_gpu(cuda_device, norm):
    """Under pallas_stem and pallas_conv an encoder forward hands every
    conv after the stem a channels-last activation: the kernels' wrappers
    copy a layout once (the stem's 15-channel NCHW input), and the output
    agrees with the same forward through the plain twins."""
    import chip_smoke

    from bflow_tpu_torch import kernels
    from bflow_tpu_torch.kernels import conv_common
    from bflow_tpu_torch.models.extractor import (
        BasicEncoder, Conv2d, init_weights)

    enc = BasicEncoder(15, 128, norm, torch.bfloat16, stem_kernel=True,
                       conv_kernel=True)
    init_weights(enc, torch.Generator().manual_seed(0))
    enc = enc.to(cuda_device).eval()
    seen = {}
    for name, mod in enc.named_modules():
        if isinstance(mod, Conv2d):
            mod.register_forward_pre_hook(
                lambda m, args, name=name: seen.__setitem__(
                    name, args[0].is_contiguous(
                        memory_format=torch.channels_last)))
    x = torch.randn(2, 15, 96, 128, device=cuda_device).bfloat16()
    kernels.reset_launch_counts()
    conv_common.reset_counters()
    with torch.no_grad():
        out = enc(x)
        with chip_smoke.plain_twins():
            want = enc(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["stem_conv"] == 3 and counts["conv3x3"] == 10, counts
    # the instance norms and eval BatchNorms go through the norm kernel,
    # which keeps the layout; GroupNorm and no norm do not reach it
    assert counts["norm"] == (15 if norm in ("instance", "batch") else 0)
    assert conv_common.layout_copies == 1
    not_cl = sorted(k for k, v in seen.items() if not v and k != "conv1")
    assert not not_cl, not_cl
    assert out.is_contiguous(memory_format=torch.channels_last)
    err = (out.float() - want.float()).abs().max() / want.float().abs().max()
    assert err < 5e-2, err.item()


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    """CUDA tensors of a type, layout or shape a kernel does not take
    raise; nothing falls back to a plain version."""
    from bflow_tpu_torch.kernels import conv3x3, corr_lookup, stem_conv

    x = torch.zeros(1, 8, 6, 10, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(16, 8, 3, 3, device=cuda_device)
    b = torch.zeros(16, device=cuda_device)
    for fn in (conv3x3.conv2d, stem_conv.stem_conv):
        with pytest.raises(TypeError):
            fn(x.float(), w, b)
        with pytest.raises(ValueError):
            fn(x, torch.zeros(16, 8, 2, 2, device=cuda_device), b)
        with pytest.raises(ValueError):
            fn(x, w, b.cpu())
    vol = torch.zeros(8, 20, 12, device=cuda_device, dtype=torch.int8)
    scale = torch.ones(2, device=cuda_device)
    coords = torch.zeros(8, 2, device=cuda_device)
    with pytest.raises(TypeError):
        corr_lookup.corr_lookup_level_q8(vol.bfloat16(), scale, coords, 4)
    with pytest.raises(ValueError):
        corr_lookup.corr_lookup_level_q8(vol.transpose(1, 2), scale, coords,
                                         4)
    with pytest.raises(ValueError):
        corr_lookup.corr_lookup_level_q8(vol, torch.ones(3,
                                                         device=cuda_device),
                                         coords, 4)
    with pytest.raises(RuntimeError, match="inference only"):
        corr_lookup.corr_lookup_level_q8(vol, scale,
                                         coords.requires_grad_(True), 4)
