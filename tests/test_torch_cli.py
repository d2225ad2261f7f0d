"""Port parity of the config composer and the evaluation entry points
(bflow_tpu_torch.{confsys, cli, val, predict_dsec} vs bflow_tpu.confsys
and the JAX package's train.py helpers, val.py and
scripts/predict_dsec.py).

Bounds: the config tree byte-identical, composed configs and model
configs equal; `val` on the CPU (f32, 5 bins, 2 iterations, a reference
style `.ckpt`, two batches of 2; and on MultiFlow samples, 6 bins, degree
2, a batch of 2 and a tail of 1) logs val/* metrics within
1e-4 relative of the JAX val.py's on the same weights and recordings (the
f32 forward's bound, tests/test_torch_model.py); `predict_dsec` writes one
PNG per window, each decoding within 1/128 px (one PNG quantum) of the JAX
script's PNG. The recordings are fabricated at 64x96: the model's
four-level frame pyramid needs H/8 and W/8 of at least 8.
"""

from __future__ import annotations

import csv
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu.confsys import ConfigError as JaxConfigError
from bflow_tpu.confsys import compose as jax_compose
from bflow_tpu_torch import cli
from bflow_tpu_torch.confsys import ConfigError, compose
from fixtures import make_dsec_sequence
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
JAX_CONFIG_DIR = ROOT / "bflow_tpu" / "config"
sys.path.insert(0, str(ROOT))

DSEC_EXP = "+experiment/dsec/raft_spline=E_I_LU4_BD2_lowpyramid"


def test_config_tree_byte_identical():
    want = {p.relative_to(JAX_CONFIG_DIR): p.read_bytes()
            for p in JAX_CONFIG_DIR.rglob("*") if p.is_file()}
    got = {p.relative_to(cli.CONFIG_DIR): p.read_bytes()
           for p in cli.CONFIG_DIR.rglob("*") if p.is_file()}
    assert len(want) >= 13
    assert sorted(got) == sorted(want)
    for rel, data in want.items():
        assert got[rel] == data, rel


# the cases of tests/test_confsys.py
COMPOSE_CASES = {
    "dsec_experiment": ("train", [
        "dataset=dsec", "model=raft-spline", "dataset.path=/data/dsec",
        "wandb.group_name=test",
        "+experiment/dsec/raft_spline=E_LU4_BD2_lowpyramid"]),
    "dsec_flagship_experiment": ("val", [
        "dataset=dsec", "model=raft-spline", "dataset.path=/d",
        "checkpoint=/c.pt", DSEC_EXP, "model.num_bins.context=15"]),
    "multiflow_experiment": ("train", [
        "dataset=multiflow_regen", "model=raft-spline",
        "dataset.path=/data/mf", "wandb.group_name=g",
        "+experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid"]),
    "typed_overrides": ("train", [
        "dataset=dsec", "model=raft-spline", "dataset.path=/d",
        "wandb.group_name=g", "training.batch_size=8",
        "hardware.devices=[0,1]", "training.lr_scheduler.use=false",
        "model.num_bins.correlation=15"]),
    "val": ("val", [
        "dataset=dsec", "model=raft-spline", "dataset.path=/d",
        "checkpoint=/ckpt/x.ckpt"]),
}


@pytest.mark.parametrize("case", sorted(COMPOSE_CASES))
def test_compose_matches_jax(case):
    name, overrides = COMPOSE_CASES[case]
    got = compose(cli.CONFIG_DIR, name, overrides)
    want = jax_compose(JAX_CONFIG_DIR, name, overrides)
    assert got == want


@pytest.mark.parametrize("overrides", [
    ["dataset=dsec", "model=raft-spline", "wandb.group_name=g"],
    ["model=raft-spline"],
    ["dataset=dsec", "model=raft-spline", "dataset.path=/d", "bad"],
])
def test_compose_errors_match_jax(overrides):
    with pytest.raises(JaxConfigError) as want:
        jax_compose(JAX_CONFIG_DIR, "train", overrides)
    with pytest.raises(ConfigError) as got:
        compose(cli.CONFIG_DIR, "train", overrides)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knobs", [
    [],
    ["model.precision.corr=bfloat16", "model.precision.compute=bfloat16",
     "model.lookup_method=gather", "model.remat_updates=true"],
    ["model.lookup_method=pallas_q8", "model.pallas_stem=true",
     "model.pallas_conv=true", "model.fuse_corr_conv=false",
     "model.scan_iters=true", "model.onehot_from_level=2"],
])
def test_model_config_from_matches_jax(knobs):
    from train import model_config_from as jax_model_config_from

    overrides = ["dataset=dsec", "model=raft-spline", "dataset.path=/d",
                 "wandb.group_name=g", DSEC_EXP,
                 "model.num_bins.context=15",
                 "model.num_bins.correlation=15", *knobs]
    got = cli.model_config_from(compose(cli.CONFIG_DIR, "train", overrides))
    want = jax_model_config_from(
        jax_compose(JAX_CONFIG_DIR, "train", overrides))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_flagship_overrides_give_flagship_config():
    """The overrides chip_smoke.py's evaluation phase passes to val."""
    config = compose(cli.CONFIG_DIR, "val", [
        "dataset=dsec", "model=raft-spline", "dataset.path=/d",
        "checkpoint=/c.pt", DSEC_EXP, "model.num_bins.context=15",
        "model.num_bins.correlation=15", "model.precision.corr=bfloat16",
        "model.precision.compute=bfloat16"])
    assert cli.model_config_from(config) == bt.flagship_config()


def test_limit_batches_matches_jax():
    from train import limit_batches as jax_limit_batches

    for limit, total in ((None, 7), (1.0, 7), (0.5, 7), (3, 7), (30, 7),
                         (1, 7)):
        assert cli.limit_batches(limit, total) == jax_limit_batches(limit,
                                                                    total)


@pytest.mark.parametrize("every_ms", [50, 100])
def test_supervision_timestamps_matches_jax(tmp_path, every_ms):
    """The port's helper on the port's MultiFlow val dataset, the JAX
    one on the JAX package's."""
    from bflow_tpu.data.multiflow2d.provider import (
        MultiflowProvider as JaxMultiflowProvider)
    from bflow_tpu_torch.data.multiflow2d.provider import MultiflowProvider
    from fixtures import make_multiflow_sample
    from train import supervision_timestamps as jax_supervision_timestamps

    for split in ("train", "val"):
        make_multiflow_sample(tmp_path / split, "seq_0001", seed=1)
    params = {
        "path": str(tmp_path), "load_voxel_grid": False,
        "normalize_voxel_grid": True, "extended_voxel_grid": True,
        "flow_every_n_ms": every_ms, "downsample": False,
        "photo_augm": False, "orig_hw": (32, 48), "crop_hw": (16, 24),
    }
    want = jax_supervision_timestamps(
        JaxMultiflowProvider(params, nbins_context=6).get_val_dataset())
    assert len(want) == 500 // every_ms
    assert cli.supervision_timestamps(
        MultiflowProvider(params, nbins_context=6).get_val_dataset()) == want


def test_multiflow_val_cli_matches_jax(tmp_path, monkeypatch):
    """MultiFlow val (72x104 samples, 6 bins, degree 2, 1 iteration, a
    batch of 2 and a tail of 1) from one reference-style .ckpt: the
    val/* metrics at the supervision timestamps within 1e-4 relative."""
    import val as jax_val

    from bflow_tpu_torch import val
    from fixtures import make_multiflow_sample

    root = tmp_path / "mf"
    for split, n in (("train", 1), ("val", 3)):
        for i in range(n):
            make_multiflow_sample(root / split, f"seq_{i:04d}", height=72,
                                  width=104, n_events=20000, seed=9 + i)
    args = ["dataset=multiflow_regen", "model=raft-spline",
            f"dataset.path={root}", "checkpoint=x",
            "+experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid",
            "model.num_bins.context=6", "model.num_bins.correlation=4",
            "model.bezier_degree=2",
            "model.correlation.ev.target_indices=[1,3,5]",
            "model.correlation.ev.levels=[1,1,2]", "model.num_iter.test=1",
            "dataset.flow_every_n_ms=100", "dataset.orig_hw=[72,104]",
            "dataset.crop_hw=[64,96]", "batch_size=2",
            "hardware.num_workers=2", "dataset.load_voxel_grid=false"]
    config = compose(cli.CONFIG_DIR, "val", args)
    model = bt.build_model(cli.model_config_from(config), "cpu", seed=5)
    ckpt = tmp_path / "released_style.ckpt"
    torch.save({"state_dict": {f"net.{k}": v
                               for k, v in model.state_dict().items()}},
               str(ckpt))
    args[3] = f"checkpoint={ckpt}"
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    out = val.main(args, device="cpu")
    got = read_csv(tmp_path / "port" / "validation_logs" / "val_metrics.csv")
    monkeypatch.chdir(tmp_path / "jax")
    jax_val.main(args)
    want = read_csv(tmp_path / "jax" / "validation_logs" / "val_metrics.csv")
    assert sorted(got) == sorted(want)
    keys = [k for k in want if k.startswith("val/")]
    assert {"val/epe_multi", "val/ae_multi", "val/epe_multi_lin",
            "val/epe"} <= set(keys)
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (
            k, got[k], want[k])
    assert out["fields"] == 3
    assert out["model_config"].bezier_degree == 2


def test_val_cuda_without_cuda_raises(monkeypatch):
    from bflow_tpu_torch import val

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        val.main(["dataset=dsec"])


# ---------------------------------------------------------------- entry points

HW = (64, 96)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """Train: 4 windows (two val batches of 2: one batch shape, so the JAX
    side compiles its eval step once; the card runs a tail batch); test:
    2."""
    root = tmp_path_factory.mktemp("dsec_cli")
    make_dsec_sequence(root / "train", "seq_a", n_flows=4, height=HW[0],
                       width=HW[1], seed=4)
    make_dsec_sequence(root / "test", "seq_t", n_flows=2, height=HW[0],
                       width=HW[1], seed=5)
    return root


@pytest.fixture(scope="module")
def checkpoint(recordings):
    """A reference-style Lightning .ckpt of seeded port weights."""
    config = compose(cli.CONFIG_DIR, "val", cli_args(recordings, "x"))
    config["model"]["num_bins"]["correlation"] = 5
    model = bt.build_model(cli.model_config_from(config), device="cpu",
                           seed=3)
    path = recordings / "released_style.ckpt"
    torch.save({"state_dict": {f"net.{k}": v
                               for k, v in model.state_dict().items()},
                "epoch": 1}, str(path))
    return path


def cli_args(root, ckpt):
    return ["dataset=dsec", "model=raft-spline", f"dataset.path={root}",
            f"checkpoint={ckpt}", DSEC_EXP, "model.num_bins.context=5",
            "model.num_iter.test=2", "batch_size=2",
            "hardware.num_workers=2", "dataset.load_voxel_grid=false",
            f"dataset.height={HW[0]}", f"dataset.width={HW[1]}"]


def read_csv(path: Path):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1
    return {k: float(v) for k, v in rows[0].items()}


def test_val_cli_matches_jax(recordings, checkpoint, tmp_path, monkeypatch):
    import val as jax_val

    from bflow_tpu_torch import val

    args = cli_args(recordings, checkpoint)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    out = val.main(args, device="cpu")
    got = read_csv(tmp_path / "port" / "validation_logs" / "val_metrics.csv")
    monkeypatch.chdir(tmp_path / "jax")
    jax_val.main(args)
    want = read_csv(tmp_path / "jax" / "validation_logs" / "val_metrics.csv")
    assert sorted(got) == sorted(want)
    keys = [k for k in want if k.startswith("val/")]
    assert {"val/epe", "val/ae", "val/1pe", "val/3pe"} <= set(keys)
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (
            k, got[k], want[k])
    assert out["fields"] == 4 and out["metrics"]["val/epe"] == pytest.approx(
        got["val/epe"])
    assert 0.0 <= out["loader_wait_share"] <= 1.0


def test_predict_dsec_matches_jax(recordings, checkpoint, tmp_path):
    sys.path.insert(0, str(ROOT / "scripts"))
    import predict_dsec as jax_predict

    from bflow_tpu.data.io import load_flow_png
    from bflow_tpu_torch import predict_dsec

    args = [a for a in cli_args(recordings, checkpoint)
            if not a.startswith(("dataset=", "model=", "batch_size"))]
    out = predict_dsec.main(args + [f"output_dir={tmp_path / 'port'}"],
                            device="cpu")
    jax_predict.main(args + [f"output_dir={tmp_path / 'jax'}"])
    got = sorted((tmp_path / "port").glob("*/*.png"))
    want = sorted((tmp_path / "jax").glob("*/*.png"))
    assert out["pngs"] == 2
    assert [p.relative_to(tmp_path / "port") for p in got] == [
        p.relative_to(tmp_path / "jax") for p in want]
    assert got[0].parent.name == "seq_t"
    for g, w in zip(got, want):
        gf, gv = load_flow_png(g)
        wf, wv = load_flow_png(w)
        assert gf.shape == (*HW, 2) and gv.all() and wv.all()
        assert np.abs(gf - wf).max() <= 1 / 128, g.name
