"""Port parity of the training entry point (bflow_tpu_torch.train.loop.main
vs the JAX package's train.main) on fabricated MultiFlow samples and DSEC
recordings at 72x104 (training crop 64x96: the model's four-level frame
pyramid needs H/8 and W/8 of at least 8), with 6 context bins, Bezier
degree 2 and 1 iteration. Both runs start from one reference-style `.ckpt`
of seeded port weights through the weights-only resume
(`wandb.artifact_name=<path> wandb.resume_only_weights=true`).

Bounds, each with its reason:
  * step-1 train loss: rtol 1e-5 (the one-step loss bound of
    tests/test_torch_train.py); `learning_rate`: rtol 1e-6 (the JAX
    schedule runs in f32);
  * the val/* metrics after the step: rtol 1e-4 (the f32 forward's
    bound, tests/test_torch_model.py);
  * the weights in `last` after the step: within 1e-5 of each leaf's
    largest |param| where the gradient is determined, and no more than
    Adam's largest first step elsewhere (tests/test_torch_train.py's
    one-step rule and its reason); BatchNorm statistics rel 1e-5;
  * the CSV columns: equal.
The weights' seed: with port weights from seed 1, 93 gradient elements of
cnet and fnet_ev (of up to 1e-2 of their leaf's largest) take opposite
signs in the two packages while the losses agree within 1e-7 (a random-init
ReLU or BatchNorm input at f32 round-off, the effect
tests/test_torch_train.py documents), and Adam's first step moves them by
+-lr apart; seeds 0 and 2-5 have no such element, and seed 2 is used.
A resumed run equals an uninterrupted one bitwise on the CPU (weights,
AdamW's moments, the scheduler, the step), whether it stopped at an
epoch's end or was interrupted inside one. The DSEC run's JAX datasets
are seeded as the port's are (the JAX ConcatDataset has no get_item, so
its Loader draws DSEC augmentation unseeded; tests/test_torch_data.py).
"""

from __future__ import annotations

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu_torch import cli
from bflow_tpu_torch.confsys import compose
from bflow_tpu_torch.train import loop
from fixtures import make_dsec_sequence, make_multiflow_sample
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HW, CROP = (72, 104), (64, 96)
MF_EXP = "+experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid"
DSEC_EXP = "+experiment/dsec/raft_spline=E_I_LU4_BD2_lowpyramid"
SMALL_MF = ["model.num_bins.context=6", "model.num_bins.correlation=4",
            "model.bezier_degree=2",
            "model.correlation.ev.target_indices=[1,3,5]",
            "model.correlation.ev.levels=[1,1,2]",
            "model.num_iter.train=1", "model.num_iter.test=1",
            "dataset.flow_every_n_ms=100",
            f"dataset.orig_hw=[{HW[0]},{HW[1]}]",
            f"dataset.crop_hw=[{CROP[0]},{CROP[1]}]"]
COMMON = ["model=raft-spline", "wandb.group_name=cli",
          "training.batch_size=2", "training.max_steps=1",
          "training.max_epochs=1", "logging.log_every_n_steps=1",
          "hardware.devices=1", "hardware.num_workers=2",
          "dataset.load_voxel_grid=false"]


def mf_args(root, out, ckpt=None, extra=()):
    args = ["dataset=multiflow_regen", f"dataset.path={root}", MF_EXP,
            *SMALL_MF, *COMMON, f"logging.out_dir={out}", *extra]
    if ckpt is not None:
        args += [f"wandb.artifact_name={ckpt}",
                 "wandb.resume_only_weights=true"]
    return args


def reference_ckpt(args, path: Path, seed: int) -> Path:
    """A reference-style Lightning .ckpt of seeded port weights for the
    model the overrides compose."""
    config = compose(cli.CONFIG_DIR, "train", args)
    cli.backfill_correlation_bins(config, cli.build_provider(config))
    model = bt.build_model(cli.model_config_from(config), "cpu", seed)
    torch.save({"state_dict": {f"net.{k}": v
                               for k, v in model.state_dict().items()},
                "epoch": 1}, str(path))
    return path


def read_rows(path: Path):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return [{k: float(v) for k, v in r.items() if v != ""} for r in rows]


@pytest.fixture(scope="module")
def mf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mf_train_cli")
    for split in ("train", "val"):
        for i in range(2):
            make_multiflow_sample(root / split, f"seq_{i:04d}",
                                  height=HW[0], width=HW[1],
                                  n_events=20000, seed=3 * i + len(split))
    return root


@pytest.fixture(scope="module")
def mf_runs(mf_root, tmp_path_factory):
    """One step and one validation from the same .ckpt through both
    packages' training entry points."""
    import train as jax_train

    work = tmp_path_factory.mktemp("mf_runs")
    ckpt = reference_ckpt(mf_args(mf_root, work), work / "start.ckpt", 2)
    out = loop.main(mf_args(mf_root, work / "port", ckpt), device="cpu")
    jax_train.main(mf_args(mf_root, work / "jax", ckpt))
    run = "cli_multiflow_regen"
    return {"ckpt": ckpt, "out": out, "port": work / "port" / run,
            "jax": work / "jax" / run, "args_root": mf_root,
            "args": mf_args(mf_root, work / "port", ckpt)}


def test_multiflow_csv_columns_match_jax(mf_runs):
    with open(mf_runs["port"] / "train_metrics.csv") as fh:
        got = next(csv.reader(fh))
    with open(mf_runs["jax"] / "train_metrics.csv") as fh:
        want = next(csv.reader(fh))
    assert got == want
    assert {"train/l1_multi_seq_loss", "learning_rate", "steps_per_sec",
            "val/epe_multi"} <= set(got)


def test_multiflow_step1_loss_and_lr_match_jax(mf_runs):
    got = read_rows(mf_runs["port"] / "train_metrics.csv")[0]
    want = read_rows(mf_runs["jax"] / "train_metrics.csv")[0]
    assert got["step"] == want["step"] == 1
    np.testing.assert_allclose(got["train/l1_multi_seq_loss"],
                               want["train/l1_multi_seq_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["learning_rate"], want["learning_rate"],
                               rtol=1e-6)
    for k in ("train/epe_multi", "train/epe", "train/ae_multi"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_multiflow_val_metrics_match_jax(mf_runs):
    got = read_rows(mf_runs["port"] / "train_metrics.csv")[1]
    want = read_rows(mf_runs["jax"] / "train_metrics.csv")[1]
    keys = sorted(k for k in want if k.startswith("val/"))
    assert len(keys) == 9 and sorted(k for k in got if k != "step") == keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert mf_runs["out"]["val_metrics"]["val/epe_multi"] == pytest.approx(
        got["val/epe_multi"])
    assert mf_runs["out"]["val_fields"] == 2


def test_multiflow_checkpoints_written(mf_runs):
    ckpt = mf_runs["port"] / "ckpt"
    assert (ckpt / "last.pt").exists() and (ckpt / "best.pt").exists()
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["last_step"] == 1 and meta["monitor"] == "val/epe_multi"
    val_epe = read_rows(mf_runs["port"] / "train_metrics.csv")[1][
        "val/epe_multi"]
    assert meta["best_score"] == pytest.approx(val_epe)
    state = torch.load(ckpt / "last.pt", weights_only=True)
    assert state["step"] == 1 and state["optimizer"]["state"]


def _port_grads(args, ckpt):
    """The port's gradients of step 1 (the Loader's first batch at epoch
    0, the weights from the .ckpt), in the state_dict's layout."""
    from bflow_tpu_torch.data.loader import Loader
    from bflow_tpu_torch.train import TaskConfig
    from bflow_tpu_torch.train.checkpoint import restore_weights_only
    from bflow_tpu_torch.train.step import make_loss_fn

    config = compose(cli.CONFIG_DIR, "train", args)
    provider = cli.build_provider(config)
    cli.backfill_correlation_bins(config, provider)
    model = bt.RAFTSpline(cli.model_config_from(config))
    restore_weights_only(ckpt, model)
    model.train()
    ds = provider.get_train_dataset()
    batch = next(iter(Loader(ds, batch_size=2, shuffle=True, seed=0,
                             num_workers=1, device="cpu")))
    task = TaskConfig("multiflow2d", multi_loss=True,
                      supervision_timestamps=cli.supervision_timestamps(ds))
    loss, _ = make_loss_fn(model, task)(batch)
    loss.backward()
    return ({**model.state_dict(),
             **{k: p.grad for k, p in model.named_parameters()}},
            config["training"])


def test_multiflow_last_weights_match_jax(mf_runs):
    import jax

    from bflow_tpu.train.checkpoint import restore_weights_only as jax_restore
    from bflow_tpu_torch.train.optimizer import build_optimizer
    from bflow_tpu_torch.weights import jax_variables_from_state_dict

    def flat(tree):
        return {"/".join(str(p.key) for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    want = jax_restore(str(mf_runs["jax"] / "ckpt" / "last"), None)
    got = jax_variables_from_state_dict(
        torch.load(mf_runs["port"] / "ckpt" / "last.pt",
                   weights_only=True)["model"])
    start = torch.load(mf_runs["ckpt"], weights_only=True)["state_dict"]
    before = flat(jax_variables_from_state_dict(
        {k[len("net."):]: v for k, v in start.items()})["params"])
    grads_sd, training = _port_grads(mf_runs["args"], mf_runs["ckpt"])
    grads = flat(jax_variables_from_state_dict(grads_sd)["params"])
    # the learning rate of step 1 (the schedule's step 0)
    lr = build_optimizer(training, [torch.zeros(1)])[0].param_groups[0]["lr"]
    wd = float(training["weight_decay"])
    got_p, want_p = flat(got["params"]), flat(want["params"])
    assert set(got_p) == set(want_p) == set(grads)
    gmax = max(np.abs(g).max() for g in grads.values())
    for k, w in want_p.items():
        g = np.abs(grads[k])
        determined = g > max(1e-2 * g.max(), 1e-5 * gmax)
        assert determined.any() or g.max() <= 1e-3 * gmax, k
        diff = np.abs(got_p[k] - w)[determined]
        assert diff.max(initial=0.0) <= 1e-5 * np.abs(w).max(), k
        p0 = np.abs(before[k])[~determined]
        step = np.abs(got_p[k] - before[k])[~determined]
        bound = lr * (1 + wd * p0) * (1 + 1e-6) + 2 * np.spacing(p0 + lr)
        assert (step <= bound).all(), k
    got_bs, want_bs = flat(got["batch_stats"]), flat(want["batch_stats"])
    assert set(got_bs) == set(want_bs) and want_bs
    for k, w in want_bs.items():
        err = np.abs(got_bs[k] - w).max() / np.abs(w).max()
        assert err <= 1e-5, k


def test_dsec_step1_loss_matches_jax(tmp_path, monkeypatch):
    import train as jax_train
    from bflow_tpu.data.provider import ConcatDataset as JaxConcat
    from test_torch_data import SeededConcat

    monkeypatch.setattr(
        JaxConcat, "get_item",
        lambda self, i, rng: SeededConcat(self).get_item(i, rng),
        raising=False)
    make_dsec_sequence(tmp_path / "dsec" / "train", "seq_a", n_flows=2,
                       height=HW[0], width=HW[1], seed=6)

    def args(out, ckpt=None):
        a = ["dataset=dsec", f"dataset.path={tmp_path / 'dsec'}", DSEC_EXP,
             "model.num_bins.context=5", "model.num_iter.train=1",
             *COMMON, "logging.only_numbers=true", f"logging.out_dir={out}",
             f"dataset.height={HW[0]}", f"dataset.width={HW[1]}",
             f"dataset.crop_hw=[{CROP[0]},{CROP[1]}]"]
        if ckpt is not None:
            a += [f"wandb.artifact_name={ckpt}",
                  "wandb.resume_only_weights=true"]
        return a

    ckpt = reference_ckpt(args(tmp_path), tmp_path / "start.ckpt", 2)
    out = loop.main(args(tmp_path / "port", ckpt), device="cpu")
    jax_train.main(args(tmp_path / "jax", ckpt))
    got = read_rows(tmp_path / "port" / "cli_dsec" / "train_metrics.csv")
    want = read_rows(tmp_path / "jax" / "cli_dsec" / "train_metrics.csv")
    assert len(got) == len(want) == 1 and got[0]["step"] == 1
    np.testing.assert_allclose(got[0]["train/l1_seq_loss"],
                               want[0]["train/l1_seq_loss"], rtol=1e-5)
    assert sorted(got[0]) == sorted(want[0])
    assert out["step"] == 1 and out["val_fields"] == 0
    assert out["samples"] == 2


# -------------------------------------------------------------- resume


def _state(run_dir: Path):
    return torch.load(run_dir / "ckpt" / "last.pt", weights_only=True)


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("where", ["epoch_end", "inside_epoch"])
def test_resume_equals_uninterrupted(mf_root, tmp_path, monkeypatch, where):
    """Two steps in one run, or one step, an end (the epoch's, or an
    interruption inside the epoch) and a resumed second: the same state,
    bitwise, and the same learning rate logged at step 2."""
    import bflow_tpu_torch.train as ttrain

    quick = ["training.max_steps=2", "training.limit_val_batches=0",
             "logging.only_numbers=true", "training.batch_size=1"]
    if where == "epoch_end":  # one batch per epoch, two epochs
        whole = quick + ["training.max_epochs=2"]
        first = quick + ["training.max_epochs=1"]
    else:  # two batches in one epoch
        whole = first = quick + ["training.limit_train_batches=2"]
    loop.main(mf_args(mf_root, tmp_path / "whole", extra=whole),
              device="cpu")

    if where == "inside_epoch":
        make = ttrain.make_train_step

        def interrupted(*a, **kw):
            step = make(*a, **kw)
            calls = []

            def run(*b, **k):
                calls.append(1)
                if len(calls) == 2:
                    raise KeyboardInterrupt
                return step(*b, **k)
            return run

        monkeypatch.setattr(ttrain, "make_train_step", interrupted)
        with pytest.raises(KeyboardInterrupt):
            loop.main(mf_args(mf_root, tmp_path / "resumed", extra=first),
                      device="cpu")
        monkeypatch.setattr(ttrain, "make_train_step", make)
    else:
        loop.main(mf_args(mf_root, tmp_path / "resumed", extra=first),
                  device="cpu")
    assert _state(tmp_path / "resumed" / "cli_multiflow_regen")["step"] == 1
    out = loop.main(mf_args(mf_root, tmp_path / "resumed", extra=whole),
                    device="cpu")
    assert out["step"] == 2 and out["samples"] == 1
    got = _state(tmp_path / "resumed" / "cli_multiflow_regen")
    want = _state(tmp_path / "whole" / "cli_multiflow_regen")
    assert got["step"] == want["step"] == 2
    _assert_tree_equal(got, want)
    lr = [read_rows(tmp_path / run / "cli_multiflow_regen"
                    / "train_metrics.csv")[-1] for run in ("resumed", "whole")]
    assert lr[0]["step"] == lr[1]["step"] == 2
    assert lr[0]["learning_rate"] == lr[1]["learning_rate"]


# -------------------------------------------------------------- errors


def test_devices_list_raises_as_jax(mf_root, tmp_path):
    """hardware.devices is a count: a list fails in both packages (the
    JAX make_mesh compares it with the number of devices)."""
    import train as jax_train

    args = mf_args(mf_root, tmp_path, extra=["hardware.devices=[0,1]"])
    with pytest.raises(TypeError):
        jax_train.main(args)
    with pytest.raises(TypeError, match="hardware.devices"):
        loop.main(args, device="cpu")
    assert not (tmp_path / "cli_multiflow_regen" / "ckpt").exists()


def test_two_cpu_ranks_match_jax(mf_runs, tmp_path):
    """hardware.devices=2 on the CPU: two gloo ranks, one sample each of
    the global batch of 2, from the same .ckpt: the step-1 row of the one
    CSV (rank 0's) within the one-step bounds of the single-process JAX
    run (module docstring)."""
    out = loop.main(mf_args(mf_runs["args_root"], tmp_path, mf_runs["ckpt"],
                            extra=["hardware.devices=2"]), device="cpu",
                    timeout_s=120)
    assert out["world"] == 2 and out["samples"] == 2
    got = read_rows(out["run_dir"] / "train_metrics.csv")
    want = read_rows(mf_runs["jax"] / "train_metrics.csv")
    assert len(got) == len(want) == 2 and got[0]["step"] == 1
    np.testing.assert_allclose(got[0]["train/l1_multi_seq_loss"],
                               want[0]["train/l1_multi_seq_loss"],
                               rtol=1e-5)
    for k in sorted(k for k in want[1] if k.startswith("val/")):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   err_msg=k)


def test_grain_loader_run_equals_threaded(mf_runs, tmp_path):
    """hardware.loader=grain: the worker-process loader's batches are the
    threaded Loader's, so the run's rows are the same, bit for bit (the
    throughput column apart)."""
    out = loop.main(mf_args(mf_runs["args_root"], tmp_path, mf_runs["ckpt"],
                            extra=["hardware.loader=grain"]), device="cpu")
    got = read_rows(out["run_dir"] / "train_metrics.csv")
    want = read_rows(mf_runs["port"] / "train_metrics.csv")
    for row in got + want:
        row.pop("steps_per_sec", None)
    assert got == want


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_cuda_raises(mf_root, tmp_path, monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.main(mf_args(mf_root, tmp_path), device=device)
    assert not (tmp_path / "cli_multiflow_regen").exists()


def test_module_entry_point_needs_cuda(mf_root, tmp_path):
    """python -m bflow_tpu_torch.train takes the overrides from argv and
    runs on the GPU: here, without one, it refuses."""
    run = subprocess.run(
        [sys.executable, "-m", "bflow_tpu_torch.train",
         *mf_args(mf_root, tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr


def test_profiler_writes_trace(mf_root, tmp_path):
    out = loop.main(mf_args(mf_root, tmp_path, extra=[
        "debugging.profiler=jax", "logging.only_numbers=true",
        "training.limit_val_batches=0", "training.batch_size=1"]),
        device="cpu")
    trace = out["run_dir"] / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert out["step"] == 1 and out["step_ms"] == []
