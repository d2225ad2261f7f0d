"""Full f32 where the config asks for f32: the port pins its f32 work as
the JAX package pins it to Precision.HIGHEST (bflow_tpu/models/
extractor.py:conv_precision, models/corr.py, ops/upsample.py,
ops/bezier.py).

PyTorch runs f32 cuDNN convolutions in TF32 unless
torch.backends.cudnn.allow_tf32 is False, and may run f32 CUDA matmuls in
TF32 while torch.backends.cuda.matmul.allow_tf32 is True. The model's
forward, the train step (forward and backward) and the eval step turn
both off for their span (bflow_tpu_torch/utils/precision.py:full_f32) and
give the caller's settings back. The flags are process-wide, so the CPU
cases read them from hooks inside those calls; the arithmetic they
switch exists only on the card, where the cuda cases hold a forward and a
train step bit-equal with the caller's flags on and off, and find the
caller's flags unchanged after val, predict_dsec and the training loop.

JAX is imported inside the case that uses it, so that the cuda cases run
on a machine without JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu_torch.models import raft_spline
from bflow_tpu_torch.ops import bezier
from bflow_tpu_torch.train import TaskConfig, TrainState, make_eval_step
from bflow_tpu_torch.train import make_train_step
from bflow_tpu_torch.utils.precision import full_f32
from test_torch_common import SMALL, make_inputs
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1, "lr_scheduler": {"use": False}}
CFG = bt.RaftSplineConfig(**{**SMALL, "iters_train": 1, "iters_test": 1})
# the caller's settings: TF32 on with cuDNN's defaults (PyTorch's own
# defaults), and TF32 off with benchmark and deterministic switched on
CALLERS = [dict(tf32=True, benchmark=False, deterministic=False),
           dict(tf32=False, benchmark=True, deterministic=True)]


def flags():
    cudnn = torch.backends.cudnn
    return dict(cudnn_tf32=cudnn.allow_tf32,
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                benchmark=cudnn.benchmark, deterministic=cudnn.deterministic)


@pytest.fixture(params=CALLERS, ids=["tf32_on", "tf32_off"])
def caller(request, monkeypatch):
    """The caller's flags set for the test (monkeypatch restores them);
    returns what flags() must read outside the port's calls."""
    c = request.param
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", c["tf32"])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", c["tf32"])
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", c["benchmark"])
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        c["deterministic"])
    return dict(cudnn_tf32=c["tf32"], matmul_tf32=c["tf32"],
                benchmark=c["benchmark"], deterministic=c["deterministic"])


def inside(caller):
    """What flags() must read inside a pinned call."""
    return {**caller, "cudnn_tf32": False, "matmul_tf32": False}


def watch(model):
    """Forward hooks on one encoder conv and one update-block conv, and
    gradient hooks on their weights, each recording flags() when it
    runs."""
    seen = {"forward": [], "backward": []}
    for conv in (model.fnet_ev.conv1, model.update_block.bezier_head.conv1):
        conv.register_forward_hook(
            lambda *_: seen["forward"].append(flags()))
        conv.weight.register_hook(
            lambda g: seen["backward"].append(flags()))
    return seen


def batch(seed=0, n=1, h=64, w=64):
    rng = np.random.default_rng(seed)
    b = {"ev_repr": rng.standard_normal((n, h, w, CFG.nbins_total)),
         "img": rng.integers(0, 255, (2, n, h, w, 3)),
         "flow": 3.0 * rng.standard_normal((n, h, w, 2)),
         "flow_valid": rng.random((n, h, w)) < 0.8}
    return {k: torch.from_numpy(v.astype(bool if k == "flow_valid"
                                         else np.float32))
            for k, v in b.items()}


@pytest.mark.parametrize("test_mode", [True, False])
def test_forward_pins_f32(caller, test_mode):
    model = bt.build_model(CFG, device="cpu", seed=0)
    seen = watch(model)
    voxel, images = make_inputs(CFG, seed=1)
    model(torch.from_numpy(voxel), torch.from_numpy(images),
          test_mode=test_mode)
    assert seen["forward"] and all(f == inside(caller)
                                   for f in seen["forward"])
    assert flags() == caller


def test_train_step_pins_forward_and_backward(caller):
    model = bt.build_model(CFG, device="cpu", seed=0)
    seen = watch(model)
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, TaskConfig("dsec"), state.optimizer,
                           state.scheduler)
    step(batch())
    assert len(seen["forward"]) == 2 and len(seen["backward"]) == 2
    assert all(f == inside(caller)
               for f in seen["forward"] + seen["backward"])
    assert flags() == caller


def test_eval_step_pins_f32(caller):
    model = bt.build_model(CFG, device="cpu", seed=0)
    seen = watch(model)
    make_eval_step(model, TaskConfig("dsec"))(batch())
    assert len(seen["forward"]) == 2
    assert all(f == inside(caller) for f in seen["forward"])
    assert flags() == caller


def test_full_f32_nests_and_restores_on_error(caller):
    with full_f32():
        with full_f32():
            assert flags() == inside(caller)
        assert flags() == inside(caller)
    assert flags() == caller
    with pytest.raises(ZeroDivisionError):
        with full_f32():
            1 / 0
    assert flags() == caller


def test_bf16_forward_unchanged_by_the_pin(monkeypatch):
    """The bf16 forward with the pin is bit-equal to the forward without
    it (the parent's code path), and within the bf16 bound of
    tests/test_precision_modes.py (5e-2) of the JAX forward."""
    import jax
    import jax.numpy as jnp

    from bflow_tpu.models import RAFTSpline as JaxRAFTSpline
    from bflow_tpu.models import RaftSplineConfig as JaxConfig
    from bflow_tpu.ops import BezierCurves as JaxBezier
    from bflow_tpu_torch.weights import load_jax_variables
    from test_torch_common import damp_head, random_variables, rel_err

    kw = {**SMALL, "iters_test": 2, "compute_dtype": "bfloat16",
          "corr_precision": "bfloat16"}
    cfg = bt.RaftSplineConfig(**kw)
    voxel, images = make_inputs(cfg, seed=0)
    jmodel = JaxRAFTSpline(JaxConfig(**kw))
    variables = damp_head(random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(voxel),
                            jnp.asarray(images), test_mode=True), 1))
    _, want = jax.jit(lambda v, x, i: jmodel.apply(v, x, i, test_mode=True))(
        variables, jnp.asarray(voxel), jnp.asarray(images))
    model = load_jax_variables(bt.build_model(cfg, device="cpu"), variables)

    def forward():
        return model(torch.from_numpy(voxel), torch.from_numpy(images),
                     test_mode=True)

    low, up = forward()
    for mod in (raft_spline, bezier):
        monkeypatch.setattr(mod, "full_f32", nullcontext)
    low0, up0 = forward()
    assert torch.equal(low.params, low0.params)
    assert torch.equal(up.params, up0.params)
    for t in (0.5, 1.0):
        assert torch.equal(up.flow_at(t), up0.flow_at(t))
        assert rel_err(up.flow_at(t).numpy(),
                       np.asarray(JaxBezier(want.params).flow_at(t))) < 5e-2


# -- on the card -------------------------------------------------------------


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")


def _set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


@pytest.fixture
def cuda_flags(monkeypatch):
    """Deterministic cuDNN for bit-equal comparisons; every flag the case
    touches comes back afterwards."""
    need_cuda()
    for mod, name in ((torch.backends.cudnn, "allow_tf32"),
                      (torch.backends.cuda.matmul, "allow_tf32"),
                      (torch.backends.cudnn, "deterministic")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    torch.backends.cudnn.deterministic = True


def _f32_cfg():
    return dataclasses.replace(CFG, iters_train=2, iters_test=2,
                               lookup_method="pallas")


@pytest.mark.cuda
def test_forward_bit_equal_with_tf32_on_and_off_cuda(cuda_flags):
    model = bt.build_model(_f32_cfg(), device="cuda", seed=0)
    voxel, images = (torch.from_numpy(a).cuda()
                     for a in make_inputs(_f32_cfg(), H=96, W=128, seed=1))
    out = {}
    for on in (True, False):
        _set_tf32(on)
        low, up = model(voxel, images, test_mode=True)
        out[on] = (low.params, up.params, up.flow_at(0.5))
        assert torch.backends.cudnn.allow_tf32 == on
        assert torch.backends.cuda.matmul.allow_tf32 == on
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


@pytest.mark.cuda
def test_train_step_bit_equal_with_tf32_on_and_off_cuda(cuda_flags):
    out = {}
    for on in (True, False):
        _set_tf32(on)
        model = bt.build_model(_f32_cfg(), device="cuda", seed=0)
        state = TrainState.create(model, TRAINING)
        step = make_train_step(model, TaskConfig("dsec"), state.optimizer,
                               state.scheduler)
        metrics = step({k: v.cuda() for k, v in batch(h=96, w=128).items()})
        out[on] = (metrics["train/l1_seq_loss"][0],
                   {k: p.grad for k, p in model.named_parameters()},
                   {k: p.detach() for k, p in model.named_parameters()})
        assert torch.backends.cudnn.allow_tf32 == on
        assert torch.backends.cuda.matmul.allow_tf32 == on
    (loss1, g1, p1), (loss0, g0, p0) = out[True], out[False]
    assert torch.equal(loss1, loss0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
    assert all(torch.equal(p1[k], p0[k]) for k in p0)


def _chip_smoke():
    """chip_smoke.py, loaded by path: its DSEC recording writer goes
    through the port's own HDF5 writer, which the card's machine needs
    (it has no h5py)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
def test_val_and_predict_at_f32_leave_the_callers_flags_cuda(
        cuda_flags, tmp_path, monkeypatch, on):
    from bflow_tpu_torch import predict_dsec, val

    cs = _chip_smoke()
    h, w = 64, 96
    root = tmp_path / "dsec"
    cs.write_dsec_recording(root / "train" / "zurich_city_00_a", 3, 0, True,
                            20_000, h, w)
    cs.write_dsec_recording(root / "test" / "interlaken_00_b", 2, 1, False,
                            20_000, h, w)
    cfg = dataclasses.replace(bt.flagship_config(), corr_precision="float32",
                              compute_dtype="float32")
    ckpt = tmp_path / "f32.pt"
    torch.save({"model": bt.build_model(cfg, "cuda", 0).state_dict()}, ckpt)
    args = cs.val_args(root, ckpt, 2, False, (), h, w, bf16=False)
    monkeypatch.chdir(tmp_path)
    _set_tf32(on)
    out = val.main(args, device="cuda")
    assert out["model_config"] == cfg and out["fields"] == 3
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (on, on)
    pred = predict_dsec.main(
        [a for a in args if not a.startswith(("dataset=", "model=",
                                              "batch_size"))]
        + [f"output_dir={tmp_path / 'submission'}"], device="cuda")
    assert pred["pngs"] == 2
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (on, on)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
def test_train_loop_leaves_the_callers_flags_cuda(cuda_flags, tmp_path,
                                                  monkeypatch, on):
    """loop.main on the card, one step of tests/test_torch_train_cli.py's
    smallest MultiFlow run (72x104 samples, 64x96 crop, 1 iteration),
    leaves both TF32 flags as the caller set them: its steps pin full f32
    themselves. (That file's fixtures write HDF5 through h5py, which the
    card's machine lacks, hence chip_smoke.py's writer here.)"""
    from bflow_tpu_torch.train import loop

    cs = _chip_smoke()
    monkeypatch.setenv("WANDB_MODE", "disabled")
    root = tmp_path / "multiflow"
    for split in ("train", "val"):
        for i in range(2):
            cs.write_multiflow_sample(root / split / f"seq_{i:04d}",
                                      3 * i + len(split), 20_000, 72, 104)
    args = ["dataset=multiflow_regen", "model=raft-spline",
            f"dataset.path={root}", cs.MF_EXPERIMENT,
            "model.num_bins.context=6", "model.num_bins.correlation=4",
            "model.bezier_degree=2",
            "model.correlation.ev.target_indices=[1,3,5]",
            "model.correlation.ev.levels=[1,1,2]",
            "model.num_iter.train=1", "model.num_iter.test=1",
            "dataset.flow_every_n_ms=100", "dataset.orig_hw=[72,104]",
            "dataset.crop_hw=[64,96]", "dataset.load_voxel_grid=false",
            "training.batch_size=2", "training.max_steps=1",
            "training.max_epochs=1", "training.limit_val_batches=0",
            "hardware.devices=1", "hardware.num_workers=2",
            "logging.only_numbers=true", "wandb.group_name=tf32",
            f"logging.out_dir={tmp_path}"]
    _set_tf32(on)
    out = loop.main(args, device="cuda")
    assert out["step"] == 1
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (on, on)
