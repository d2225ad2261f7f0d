"""Port parity of the released-checkpoint tool
(bflow_tpu_torch.parity_released vs scripts/parity_released.py) and of the
reference-oracle copy, on the CPU.

The JAX tool is loaded by path; its infer_config and its val hand-off need
no reference tree. The port's random-init export stands in for a
released .ckpt: the JAX importer (bflow_tpu/importer/torch_ckpt.py),
which raises on an unknown key or an unfilled leaf, consumes it strictly.
Bounds: configs, names, argv and dicts equal; weights through the JAX
importer and back bit-equal; our_flow in f32 at 128x128 and 2 iterations
against the JAX our_flow 1e-4 of max|ref| (the events-only families).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu_torch import parity_released as pr
from bflow_tpu_torch.importer import reference_oracle as oracle
from bflow_tpu_torch.train.checkpoint import restore_weights_only
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = [name for name, _ in pr.RELEASED_FAMILIES]


@pytest.fixture(scope="module")
def jpr():
    """scripts/parity_released.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_parity_released", ROOT / "scripts" / "parity_released.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name):
    kw = dict(pr.RELEASED_FAMILIES)[name]
    seed = FAMILIES.index(name)
    cfg = bt.RaftSplineConfig(**kw)
    return cfg, pr.random_init_state_dict(cfg, seed)


@pytest.fixture(scope="module")
def exports():
    return {name: family(name) for name in FAMILIES}


def test_released_families_match(jpr):
    assert pr.RELEASED_FAMILIES == jpr.RELEASED_FAMILIES


@pytest.mark.parametrize("name", FAMILIES)
def test_infer_config_matches_jax(jpr, exports, name):
    cfg, sd = exports[name]
    got, got_name = pr.infer_config(sd)
    want, want_name = jpr.infer_config(sd)
    assert got_name == want_name and got_name.startswith(name + " ")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == cfg  # the family's own config


@pytest.mark.parametrize("name", FAMILIES)
def test_export_is_the_reference_layout(exports, name):
    """The JAX importer consumes the export strictly; its flax variables
    carried back into the port give the export's values."""
    import jax
    import jax.numpy as jnp

    from bflow_tpu.importer.torch_ckpt import convert_state_dict
    from bflow_tpu.models import RAFTSpline as JaxRAFTSpline
    from bflow_tpu.models import RaftSplineConfig as JaxConfig

    cfg, sd = exports[name]
    jcfg = JaxConfig(**dict(pr.RELEASED_FAMILIES)[name])
    model = JaxRAFTSpline(jcfg)
    h = w = 64
    images = jnp.zeros((2, 1, h, w, 3)) if cfg.use_images else None
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, cfg.nbins_total)),
        images, test_mode=True))
    variables = convert_state_dict(sd, template)
    assert all(k.startswith("net.") for k in sd)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    norm3 = [k for k in sd if ".norm3." in k]
    assert norm3 and all(torch.equal(
        sd[k], sd[k.replace(".norm3.", ".downsample.1.")]) for k in norm3)
    port = load_jax_variables(bt.build_model(cfg, device="cpu", seed=99),
                              variables)
    got = port.state_dict()
    for k, v in sd.items():
        if ".norm3." not in k:
            assert torch.equal(got[k[len("net."):]], v), k
    # conv weights are OIHW and damped, norm scales are not
    assert sd["net.fnet_ev.conv1.weight"].shape[:2] == (
        64, cfg.nbins_correlation)
    w0 = bt.build_model(cfg, device="cpu", seed=FAMILIES.index(name))
    torch.testing.assert_close(sd["net.cnet.conv1.weight"],
                               w0.cnet.conv1.weight * 0.05)


def test_ckpt_round_trip(tmp_path, exports):
    cfg, sd = exports["E_I_LU4_BD2"]
    path = tmp_path / "E_I_LU4_BD2.ckpt"
    torch.save({"state_dict": {**sd, "other.buffer": torch.zeros(1)},
                "epoch": 3, "global_step": 7}, path)
    loaded = pr.load_state_dict(str(path))
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    model = restore_weights_only(str(path),
                                 bt.build_model(cfg, device="cpu", seed=5))
    got = model.state_dict()
    for k, v in sd.items():
        if ".norm3." not in k:
            assert torch.equal(got[k[len("net."):]], v), k


def test_restore_reads_a_reference_layout_ckpt(tmp_path, exports):
    """A reference state dict holds each downsample norm twice (norm3 and
    downsample.1) and BatchNorm's num_batches_tracked; both load."""
    cfg, sd = exports["E_I_LU4_BD2"]
    full = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            full[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7))
    assert any(".norm3.running_mean" in k for k in full)
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": full}, path)
    model = restore_weights_only(str(path),
                                 bt.build_model(cfg, device="cpu", seed=5))
    assert int(model.cnet.norm1.num_batches_tracked) == 7
    torch.testing.assert_close(
        model.cnet.layer2[0].downsample[1].running_mean,
        sd["net.cnet.layer2.0.downsample.1.running_mean"])


@pytest.mark.parametrize("name", ["E_LU4_BD2", "E_LU5_BD10"])
def test_our_flow_matches_jax(jpr, exports, name):
    cfg, sd = exports[name]
    jcfg, _ = jpr.infer_config(sd)
    voxel, images = pr.random_inputs(cfg, (128, 128))
    times = (0.5, 1.0)
    want = jpr.our_flow(jcfg, sd, voxel, images, iters=2, times=times,
                        precision="float32")
    got = pr.our_flow(cfg, sd, voxel, images, iters=2, times=times,
                      precision="float32", device="cpu")
    for t in times:
        assert got[t].shape == want[t].shape == (1, 2, 128, 128)
        ref = np.abs(want[t]).max()
        assert ref > 0
        assert np.abs(got[t] - want[t]).max() <= 1e-4 * ref, t


@pytest.mark.parametrize("name", FAMILIES)
def test_model_params_dict_matches_jax(exports, name):
    from bflow_tpu.importer import reference_oracle as joracle
    from bflow_tpu.models import RaftSplineConfig as JaxConfig

    cfg, _ = exports[name]
    jcfg = JaxConfig(**dict(pr.RELEASED_FAMILIES)[name])
    assert oracle.model_params_dict(cfg) == joracle.model_params_dict(jcfg)


def test_oracle_availability_matches_jax(tmp_path, monkeypatch):
    """Pointed at the same tree, the two copies agree on whether it holds
    a reference network."""
    from bflow_tpu.importer import reference_oracle as joracle

    for present in (False, True):
        if present:
            (tmp_path / "models").mkdir()
        monkeypatch.setattr(oracle, "REFERENCE_ROOT", tmp_path)
        monkeypatch.setattr(joracle, "REFERENCE_ROOT", tmp_path)
        assert oracle.reference_available() is present
        assert joracle.reference_available() is present


@pytest.mark.parametrize("value", [None, "", "tree"])
def test_oracle_root_only_from_the_environment(tmp_path, monkeypatch,
                                               value):
    """The port reads the reference tree only where BFLOW_REFERENCE_ROOT
    points: unset or empty, there is no tree and loading one raises."""
    import importlib

    (tmp_path / "models").mkdir()
    if value is None:
        monkeypatch.delenv("BFLOW_REFERENCE_ROOT", raising=False)
    else:
        monkeypatch.setenv("BFLOW_REFERENCE_ROOT",
                           str(tmp_path) if value else "")
    try:
        importlib.reload(oracle)
        if value:
            assert oracle.REFERENCE_ROOT == tmp_path
            assert oracle.reference_available()
        else:
            assert oracle.REFERENCE_ROOT is None
            assert not oracle.reference_available()
            with pytest.raises(FileNotFoundError, match="no reference"):
                oracle.load_reference_raft()
    finally:
        monkeypatch.undo()
        importlib.reload(oracle)


@pytest.mark.parametrize("name", FAMILIES)
def test_val_handoff_composes_the_jax_argv(jpr, exports, tmp_path,
                                           monkeypatch, name):
    """dataset.path=... hands the JAX tool's val argv to the port's val."""
    cfg, sd = exports[name]
    path = tmp_path / f"{name}.ckpt"
    torch.save({"state_dict": sd}, path)
    extra = ["dataset.path=/data/x", "batch_size=2"]
    stub_flow = lambda **kw: {t: None for t in kw["times"]}  # noqa: E731

    seen = {}
    fake_val = types.ModuleType("val")
    fake_val.main = lambda argv: seen.setdefault("jax", argv)
    monkeypatch.setitem(sys.modules, "val", fake_val)
    monkeypatch.setattr(jpr, "our_flow", stub_flow)
    monkeypatch.setattr(sys, "argv", ["parity_released.py", str(path),
                                      *extra, "--skip-torch"])
    jpr.main()

    from bflow_tpu_torch import val

    monkeypatch.setattr(pr, "our_flow", stub_flow)
    monkeypatch.setattr(val, "main", lambda argv, device: seen.setdefault(
        "port", (argv, device)))
    out = pr.main([str(path), *extra, "--skip-torch"], device="cpu")
    assert seen["port"] == (seen["jax"], "cpu")
    assert seen["jax"] == pr.val_argv(cfg, str(path), extra)
    assert out["val"] == seen["port"]


def test_main_on_cpu(tmp_path, exports, capsys):
    """The tool end to end at a small size: f32, bf16 and the int8 volume
    mode (level 0 quantizes at 256x256), the oracle skipped."""
    cfg, sd = exports["E_LU4_BD2"]
    path = tmp_path / "E_LU4_BD2.ckpt"
    torch.save({"state_dict": sd}, path)
    out = pr.main([str(path), "--iters", "1", "--size", "256", "256",
                   "--times", "0.5,1.0", "--bf16-also", "--q8-also"],
                  device="cpu")
    text = capsys.readouterr().out
    assert "inferred architecture: E_LU4_BD2 (ctx=15, corr=15)" in text
    assert "torch oracle skipped" in text
    assert set(out["flows"]) == {"float32", "bfloat16", "pallas_q8"}
    assert 0 < out["rel"]["bf16_vs_f32"] < 5e-2
    assert 0 < out["rel"]["q8_vs_bf16"] < 5e-2
    for flows in out["flows"].values():
        assert all(np.isfinite(f).all() and f.shape == (1, 2, 256, 256)
                   for f in flows.values())


@pytest.mark.parametrize("all_families", [False, True], ids=["ckpt", "all"])
def test_main_runs_the_oracle_at_full_f32(tmp_path, exports, monkeypatch,
                                          all_families):
    """The reference oracle's own torch forward runs under full_f32 in both
    of the tool's paths: TF32 off inside it, and the caller's flags (on
    here) on again after main. The oracle is a stub that records the flags
    and answers with the port's f32 flow."""
    seen = []

    def torch_forward_flow(cfg, sd, voxel, images, iters, times):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return pr.our_flow(cfg=cfg, sd=sd, voxel_nchw=voxel,
                           images_nchw=images, iters=iters, times=times,
                           precision="float32", device="cpu")

    monkeypatch.setattr(oracle, "reference_available", lambda: True)
    monkeypatch.setattr(oracle, "torch_forward_flow", torch_forward_flow)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if all_families:
        argv = ["--all"]
    else:
        cfg, sd = exports["E_LU4_BD2"]
        path = tmp_path / "E_LU4_BD2.ckpt"
        torch.save({"state_dict": sd}, path)
        argv = [str(path)]
    pr.main([*argv, "--iters", "1", "--size", "64", "64"], device="cpu")
    assert seen == [(False, False)] * (len(FAMILIES) if all_families else 1)
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.cuda
def test_main_turns_tf32_off_on_gpu(tmp_path, exports, monkeypatch):
    """The f32 parity mode is full f32 on the card, with TF32 off inside
    the tool's forwards only (utils/precision.py:full_f32): its f32 flows
    with the caller's flags on equal those with them off (deterministic
    cuDNN), and the caller's flags are as it set them after main."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tool's CUDA path")
    for mod, name in ((torch.backends.cuda.matmul, "allow_tf32"),
                      (torch.backends.cudnn, "allow_tf32"),
                      (torch.backends.cudnn, "deterministic")):
        monkeypatch.setattr(mod, name, True)
    cfg, sd = exports["E_LU4_BD2"]
    path = tmp_path / "E_LU4_BD2.ckpt"
    torch.save({"state_dict": sd}, path)
    flows = {}
    for on in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        out = pr.main([str(path), "--iters", "1", "--skip-torch"])
        assert torch.backends.cuda.matmul.allow_tf32 == on
        assert torch.backends.cudnn.allow_tf32 == on
        flows[on] = out["flows"]["float32"]
    assert all(np.isfinite(f).all() for f in flows[True].values())
    assert all(np.array_equal(flows[True][t], flows[False][t])
               for t in flows[False])


def test_all_on_cpu(capsys):
    if oracle.reference_available():
        pytest.skip("the reference tree is present: --all runs the oracle")
    rows = pr.main(["--all", "--iters", "1", "--size", "64", "64"],
                   device="cpu")["rows"]
    assert [r[0] for r in rows] == FAMILIES
    assert all(r[1] is None for r in rows)  # the oracle is absent here
    assert capsys.readouterr().out.count("oracle skipped") == 8
