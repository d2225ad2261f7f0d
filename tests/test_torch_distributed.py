"""Data-parallel training of the port (bflow_tpu_torch.parallel) on CPU
ranks over gloo, against one process and against the JAX package.

The counterpart of tests/test_multihost.py: a step of two ranks, each on
its half of a batch, equals one process's step on the whole batch, and the
JAX package's step on it (one program over the global batch), from the
same numpy-seeded weights carried over with `weights.load_jax_variables`.
The halves' `flow_valid` shares differ (about 30% and 90%), so a mean of
the ranks' masked means would show as a different loss. The ranks meet
through a file under the test's tmp_path (`distributed.spawn`: no TCP
port to race for under xdist), and every spawn has a timeout.

Bounds, those of tests/test_torch_train.py, with their reasons there:
loss rel 1e-5; each gradient within 1e-3 of its leaf's largest |grad| (or
of 1e-3 of the model's largest); parameters after the step rel 1e-5 of
the leaf's largest where the gradient is determined, Adam's largest first
step elsewhere; BatchNorm running statistics rel 1e-5; metrics rtol 1e-4.
The seeds are ones whose ReLUs sit clear of f32 round-off in all three
runs (a batch of one and of two per convolution round differently).
"""

from __future__ import annotations

import copy
import re

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu_torch.parallel import distributed, mesh
from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step
from bflow_tpu_torch.train.step import data_parallel, make_loss_fn
from bflow_tpu_torch.weights import (
    jax_variables_from_state_dict,
    load_jax_variables,
)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_common import rel_err

# tests/test_torch_train.py's configs: f32, 2 iterations, the gather lookup
DSEC = dict(nbins_context=5, nbins_correlation=5,
            ev_target_indices=(1, 2, 3, 4), ev_levels=(1, 1, 1, 2),
            use_images=True, iters_train=2, iters_test=2,
            lookup_method="gather")
MULTIFLOW = dict(nbins_context=11, nbins_correlation=7, bezier_degree=4,
                 ev_target_indices=(2, 4, 6, 8, 10),
                 ev_levels=(1, 1, 1, 1, 2), use_images=False,
                 iters_train=2, iters_test=2, lookup_method="gather")
CONFIGS = {"dsec": DSEC, "multiflow2d": MULTIFLOW}
MF_TIMES = (0.25, 0.5, 0.75, 1.0)
TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1, "lr_scheduler": {"use": False}}
N, H, W = 2, 32, 32
VALID_SHARES = (0.3, 0.9)  # per sample: one per rank
SEEDS = {"dsec": 0, "multiflow2d": 4}
TIMEOUT_S = 120.0


def _batch(family: str, seed: int):
    rng = np.random.default_rng(seed)
    if family == "dsec":
        share = np.asarray(VALID_SHARES)[:, None, None]
        return {
            "ev_repr": rng.standard_normal((N, H, W, 9)).astype(np.float32),
            "img": rng.integers(0, 255, (2, N, H, W, 3)).astype(np.float32),
            "flow": (3.0 * rng.standard_normal((N, H, W, 2))).astype(
                np.float32),
            "flow_valid": rng.random((N, H, W)) < share,
        }
    return {
        "ev_repr": rng.standard_normal((N, H, W, 17)).astype(np.float32),
        "flow": (3.0 * rng.standard_normal((len(MF_TIMES), N, H, W, 2))
                 ).astype(np.float32),
    }


def _task(family: str) -> TaskConfig:
    if family == "dsec":
        return TaskConfig("dsec")
    return TaskConfig("multiflow2d", multi_loss=True,
                      supervision_timestamps=MF_TIMES)


def _model(family, variables):
    model = bt.build_model(bt.RaftSplineConfig(**CONFIGS[family]), "cpu")
    return load_jax_variables(model, copy.deepcopy(variables))


def _port_step(family, variables, batch, device=None, backend=None):
    """On this rank's slice of ``batch`` (the whole batch without a
    process group): the global loss, the reduced gradients and the
    statistics of one train-mode forward and backward, then the metrics
    and state after one make_train_step from the same weights."""
    torch.set_num_threads(1)
    tb = {k: torch.from_numpy(v) for k, v in mesh.shard_batch(batch).items()}
    model = _model(family, variables).train()
    forward = data_parallel(model) if distributed.is_initialized() else None
    loss, metrics = make_loss_fn(model, _task(family), forward)(tb)
    loss.backward()
    key = next(k for k in metrics if "seq_loss" in k)
    grads = {**model.state_dict(),
             **{k: p.grad.clone() for k, p in model.named_parameters()}}
    model = _model(family, variables)
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, _task(family), state.optimizer,
                           state.scheduler)
    out_metrics = {k: (float(v), float(w)) for k, (v, w) in step(tb).items()}
    return {"loss": float(metrics[key][0]), "grads": grads,
            "metrics": out_metrics,
            "state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()}}


def _jax_step(family, variables, batch):
    """The JAX package's make_train_step on the whole batch: loss,
    gradients, state and metrics (tests/test_torch_train.py's recipe)."""
    import jax
    import jax.numpy as jnp
    import optax

    from bflow_tpu.models import RAFTSpline, RaftSplineConfig
    from bflow_tpu.train import TaskConfig as JaxTask
    from bflow_tpu.train import TrainState as JaxState
    from bflow_tpu.train import build_optimizer, make_train_step as jstep

    task = _task(family)
    jtask = JaxTask(task.dataset, multi_loss=task.multi_loss,
                    supervision_timestamps=task.supervision_timestamps)
    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(record, build_optimizer(TRAINING)[0])
    step = jstep(RAFTSpline(RaftSplineConfig(**CONFIGS[family])), jtask, tx)
    state, metrics = jax.jit(step)(
        JaxState.create(variables, tx),
        {k: jnp.asarray(v) for k, v in batch.items()})
    key = next(k for k in metrics if "seq_loss" in k)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"loss": float(metrics[key][0]), "grads": to_np(state.opt_state[0]),
            "metrics": {k: (float(v), float(w))
                        for k, (v, w) in metrics.items()},
            "params": to_np(state.params),
            "batch_stats": to_np(state.batch_stats)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _flax(sd, collection):
    return _flat(jax_variables_from_state_dict(sd)[collection])


@pytest.fixture(scope="module", params=["dsec", "multiflow2d"])
def port_runs(request, tmp_path_factory):
    """One port process and two port ranks on one batch, from weights
    drawn into the JAX package's variables."""
    from test_torch_common import random_variables

    family = request.param
    seed = SEEDS[family]
    batch = _batch(family, seed)
    variables = _jax_init(family, batch, seed + 1, random_variables)
    one = _port_step(family, variables, batch)
    two = distributed.spawn(_port_step, 2, args=(family, variables, batch),
                            device="cpu", timeout_s=TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp("ranks"))
    return family, variables, batch, one, two


@pytest.fixture(scope="module")
def runs(port_runs):
    """port_runs and the JAX step on the same weights and whole batch."""
    family, variables, batch, one, two = port_runs
    return family, variables, _jax_step(family, variables, batch), one, two


def _jax_init(family, batch, seed, random_variables):
    import jax
    import jax.numpy as jnp

    from bflow_tpu.models import RAFTSpline, RaftSplineConfig

    model = RAFTSpline(RaftSplineConfig(**CONFIGS[family]))
    return random_variables(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.asarray(batch["ev_repr"]),
                           None if "img" not in batch
                           else jnp.asarray(batch["img"])), seed)


def _port_view(r):
    """A port run's results in flax space."""
    return {"loss": r["loss"], "grads": _flax(r["grads"], "params"),
            "params": _flax(r["state_dict"], "params"),
            "batch_stats": _flax(r["state_dict"], "batch_stats"),
            "metrics": r["metrics"]}


def _pairs(runs):
    """(name, got, want) of each comparison with the JAX step, in flax
    space."""
    _, _, jax_run, one, two = runs
    want_jax = {"loss": jax_run["loss"], "grads": _flat(jax_run["grads"]),
                "params": _flat(jax_run["params"]),
                "batch_stats": _flat(jax_run["batch_stats"]),
                "metrics": jax_run["metrics"]}
    return [("two ranks vs JAX", _port_view(two), want_jax),
            ("one process vs JAX", _port_view(one), want_jax)]


def _check_loss(name, got, want, rtol=1e-5):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol,
                               err_msg=name)


def _check_grads(name, got, want):
    assert set(got["grads"]) == set(want["grads"]), name
    gmax = max(np.abs(w).max() for w in want["grads"].values())
    for k, w in want["grads"].items():
        bound = 1e-3 * max(np.abs(w).max(), 1e-3 * gmax)
        assert np.abs(got["grads"][k] - w).max() <= bound, (name, k)


def _check_params(name, got, want, variables, grads):
    before = _flat(variables["params"])
    gmax = max(np.abs(g).max() for g in grads.values())
    lr, wd = TRAINING["learning_rate"], TRAINING["weight_decay"]
    for k, w in want["params"].items():
        g = np.abs(grads[k])
        determined = g > max(1e-2 * g.max(), 1e-5 * gmax)
        diff = np.abs(got["params"][k] - w)[determined]
        assert diff.max(initial=0.0) <= 1e-5 * np.abs(w).max(), (name, k)
        p0 = np.abs(before[k])[~determined]
        # either run may move an undetermined weight by Adam's first
        # step, lr (1 + wd |p|), in either direction
        bound = 2 * lr * (1 + wd * p0) * (1 + 1e-6) + 4 * np.spacing(p0 + lr)
        gap = np.abs(got["params"][k] - w)[~determined]
        assert (gap <= bound).all(), (name, k)


def _check_batch_norm(name, got, want, variables):
    before = _flat(variables["batch_stats"])
    assert set(got["batch_stats"]) == set(want["batch_stats"]) != set()
    for k, w in want["batch_stats"].items():
        assert not np.allclose(w, before[k]), (name, k)
        assert rel_err(got["batch_stats"][k], w) < 1e-5, (name, k)


def _check_metrics(name, got, want):
    assert set(got["metrics"]) == set(want["metrics"]), name
    for k, (v, w) in want["metrics"].items():
        assert got["metrics"][k][1] == w, (name, k)
        np.testing.assert_allclose(got["metrics"][k][0], v, rtol=1e-4,
                                   atol=1e-4, err_msg=f"{name} {k}")


def test_valid_shares_differ():
    valid = _batch("dsec", SEEDS["dsec"])["flow_valid"]
    shares = valid.reshape(N, -1).mean(axis=1)
    assert abs(shares[0] - 0.3) < 0.05 and abs(shares[1] - 0.9) < 0.05


def test_two_ranks_match_one_process(port_runs):
    """Loss, gradients, parameters after the step, BatchNorm statistics
    and metrics of two ranks against one process on the whole batch."""
    _, variables, _, one, two = port_runs
    name = "two ranks vs one process"
    got, want = _port_view(two), _port_view(one)
    _check_loss(name, got, want)
    _check_grads(name, got, want)
    _check_params(name, got, want, variables, want["grads"])
    _check_batch_norm(name, got, want, variables)
    _check_metrics(name, got, want)


def test_two_ranks_loss(runs):
    for name, got, want in _pairs(runs):
        _check_loss(name, got, want)


def test_two_ranks_grads(runs):
    for name, got, want in _pairs(runs):
        _check_grads(name, got, want)


def test_two_ranks_params_after_step(runs):
    _, variables, jax_run, _, _ = runs
    for name, got, want in _pairs(runs):
        _check_params(name, got, want, variables, _flat(jax_run["grads"]))


def test_two_ranks_batch_norm_statistics(runs):
    for name, got, want in _pairs(runs):
        _check_batch_norm(name, got, want, runs[1])


def test_two_ranks_metrics(runs):
    for name, got, want in _pairs(runs):
        _check_metrics(name, got, want)


# ---------------------------------------------------------------------------
# world size 1, the all-reduce, the helpers


def test_world_size_one_equals_no_group(tmp_path):
    """One rank through DDP, the global BatchNorm, the loss's count and
    the packed metrics equals no process group: the loss within 1e-6,
    the rest within the JAX bounds (f32 round-off apart: the global
    BatchNorm takes E[x^2] - E[x]^2, the local one two passes, and the
    gradients that are zero in exact arithmetic, of the conv biases in
    front of a norm, are round-off in both)."""
    from test_torch_common import random_variables

    batch = _batch("dsec", 0)
    variables = _jax_init("dsec", batch, 1, random_variables)
    alone = _port_view(_port_step("dsec", variables, batch))
    ranked = _port_view(distributed.spawn(
        _port_step, 1, args=("dsec", variables, batch), device="cpu",
        timeout_s=TIMEOUT_S, workdir=tmp_path))
    name = "one rank vs no process group"
    _check_loss(name, ranked, alone, rtol=1e-6)
    _check_grads(name, ranked, alone)
    _check_params(name, ranked, alone, variables, alone["grads"])
    _check_batch_norm(name, ranked, alone, variables)
    _check_metrics(name, ranked, alone)


def _all_reduce_grad(device=None, backend=None):
    rank = distributed.process_index()
    x = torch.arange(4.0, requires_grad=True) * (rank + 1)
    x.retain_grad()
    y = distributed.all_reduce_sum(x)
    weights = torch.tensor([1.0, -2.0, 3.0, 0.5]) * (rank + 2)
    (weights * y).sum().backward()
    return {"y": y.detach(), "grad": x.grad, "rank": rank}


def test_all_reduce_sum_forward_and_gradient(tmp_path):
    """y = sum_r x_r on every rank; d(sum_r w_r . y)/dx_q = sum_r w_r on
    every rank q: the backward sums the cotangents over the ranks."""
    out = distributed.spawn(_all_reduce_grad, 2, device="cpu",
                            timeout_s=TIMEOUT_S, workdir=tmp_path)
    torch.testing.assert_close(out["y"], torch.arange(4.0) * 3)
    base = torch.tensor([1.0, -2.0, 3.0, 0.5])
    torch.testing.assert_close(out["grad"], base * (2 + 3))
    # without a process group: the identity, and its gradient
    x = torch.ones(3, requires_grad=True)
    (distributed.all_reduce_sum(x) * 2).sum().backward()
    torch.testing.assert_close(x.grad, torch.full((3,), 2.0))


def test_helpers_single_process_match_jax(monkeypatch):
    """tests/test_padder_timers.py:120-131 for both packages."""
    from bflow_tpu.parallel import distributed as jdist

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize_distributed() is False
    assert jdist.initialize_distributed() is False
    assert distributed.is_primary_host() and jdist.is_primary_host()
    for n in (1, 8):
        got = distributed.host_local_batch_slice(n)
        want = jdist.host_local_batch_slice(n)
        assert (got.start, got.stop) == (want.start, want.stop) == (0, n)
    assert (distributed.process_index(), distributed.process_count()) == (
        0, 1)


def _helpers(device=None, backend=None):
    sl = distributed.host_local_batch_slice(8)
    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, float(distributed.process_index()))
    model.register_buffer("count", torch.tensor(
        [distributed.process_index() + 5]))
    mesh.replicate(model)
    return {"rank": distributed.process_index(),
            "world": distributed.process_count(),
            "primary": distributed.is_primary_host(),
            "slice": (sl.start, sl.stop), "weight": model.weight.detach(),
            "count": model.count}


def test_helpers_on_two_ranks(tmp_path):
    out = distributed.spawn(_helpers, 2, device="cpu", timeout_s=TIMEOUT_S,
                            workdir=tmp_path)
    assert out["rank"] == 0 and out["world"] == 2 and out["primary"]
    assert out["slice"] == (0, 4)
    assert float(out["weight"].abs().max()) == 0.0
    assert int(out["count"]) == 5


def test_host_local_batch_slice_of_rank_one(tmp_path):
    out = distributed.spawn(_rank_one_slice, 2, device="cpu",
                            timeout_s=TIMEOUT_S, workdir=tmp_path)
    assert out == {"slice": (4, 8), "primary": False, "rank": 1}


def _rank_one_slice(device=None, backend=None):
    """Rank 1's view, handed back through rank 0."""
    sl = distributed.host_local_batch_slice(8)
    mine = torch.tensor([sl.start, sl.stop, distributed.process_index(),
                         int(distributed.is_primary_host())])
    got = [torch.zeros_like(mine) for _ in range(2)]
    torch.distributed.all_gather(got, mine)
    s, e, r, p = got[1].tolist()
    return {"slice": (s, e), "primary": bool(p), "rank": r}


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_matches_jax_sharding(world):
    """Rank r's slice is the r-th shard of the JAX package's batch
    sharding over a `world`-device data mesh (IMG and a 5-D FLOW on axis
    1, everything else on axis 0)."""
    from bflow_tpu.parallel import make_mesh, shard_batch as jax_shard

    rng = np.random.default_rng(3)
    batch = {
        "ev_repr": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
        "img": rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32),
        "flow": rng.standard_normal((5, 4, 8, 8, 2)).astype(np.float32),
        "flow_valid": rng.random((4, 8, 8)) < 0.5,
    }
    sharded = jax_shard(batch, make_mesh(n_devices=world))
    for rank in range(world):
        got = mesh.shard_batch(batch, rank, world)
        for key, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == arr.sharding.mesh.devices[rank])
            np.testing.assert_array_equal(got[key], np.asarray(shard.data),
                                          err_msg=f"{key} rank {rank}")


def test_dryrun_multichip_two_cpu_ranks(capsys):
    from bflow_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, "cpu", timeout_s=TIMEOUT_S)
    assert out["ranks"] == 2 and np.isfinite(out["loss"])
    assert (out["iters"], out["nbins"], out["lookup"]) == (12, 15, "pallas")
    assert re.search(r"dryrun_multichip OK: 2 ranks", capsys.readouterr().out)


# ---------------------------------------------------------------------------
# the training CLI over two ranks


def test_loop_two_ranks_match_one(tmp_path):
    """loop.main with hardware.devices=2 (two CPU ranks over gloo) at the
    global batch of a one-rank run: one CSV with the same losses and
    metrics (rtol 1e-5; the val/* rows 1e-4, the f32 forward's bound) and
    the checkpoints of rank 0 alone."""
    import json

    from fixtures import make_multiflow_sample
    from test_torch_train_cli import HW, mf_args, read_rows

    from bflow_tpu_torch.train import loop

    root = tmp_path / "data"
    for split in ("train", "val"):
        for i in range(2):
            make_multiflow_sample(root / split, f"seq_{i:04d}", height=HW[0],
                                  width=HW[1], n_events=20000,
                                  seed=3 * i + len(split))
    extra = ["logging.only_numbers=true"]
    one = loop.main(mf_args(root, tmp_path / "one",
                            extra=extra + ["hardware.devices=1"]),
                    device="cpu")
    two = loop.main(mf_args(root, tmp_path / "two",
                            extra=extra + ["hardware.devices=2"]),
                    device="cpu", timeout_s=TIMEOUT_S)
    assert (one["world"], two["world"]) == (1, 2)
    assert one["samples"] == two["samples"] == 2
    assert one["val_fields"] == two["val_fields"] == 2
    run = two["run_dir"]
    assert sorted(p.name for p in run.iterdir()) == ["ckpt",
                                                     "train_metrics.csv"]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [
        "best.pt", "last.pt", "meta.json"]
    assert json.loads((run / "ckpt" / "meta.json").read_text())[
        "last_step"] == 1
    got = read_rows(run / "train_metrics.csv")
    want = read_rows(one["run_dir"] / "train_metrics.csv")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            if k in ("steps_per_sec", "step"):
                continue
            rtol = 1e-4 if k.startswith("val/") else 1e-5
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def test_loop_spawns_ranks_without_a_deadline(tmp_path, monkeypatch):
    """A training run's ranks are not killed after some minutes:
    loop.main hands distributed.spawn no deadline unless its caller
    sets one."""
    from test_torch_train_cli import mf_args

    from bflow_tpu_torch.train import loop

    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    calls = []

    def fake_spawn(fn, world, **kwargs):
        calls.append((world, kwargs.get("timeout_s")))
        return {}

    monkeypatch.setattr(distributed, "spawn", fake_spawn)
    args = mf_args(tmp_path, tmp_path, extra=["hardware.devices=2"])
    loop.main(args, device="cpu")
    loop.main(args, device="cpu", timeout_s=30.0)
    assert calls == [(2, None), (2, 30.0)]


def _sleep(device=None, backend=None):
    import time

    time.sleep(60)


def test_spawn_deadline_ends_the_ranks(tmp_path):
    """Past ``timeout_s`` spawn kills its ranks and raises."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 ranks ran past 3"):
        distributed.spawn(_sleep, 2, device="cpu", timeout_s=3.0,
                          workdir=tmp_path)
    assert time.monotonic() - t0 < 30


def test_world_size_follows_hardware_devices_and_the_launcher(monkeypatch):
    """hardware.devices keeps its JAX meaning (null: every device there
    is, 1 on the CPU; a list fails); under a launcher the ranks are the
    launcher's, and a count must agree with them."""
    from bflow_tpu_torch.train.loop import world_size

    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert world_size(None, "cpu") == 1
    assert world_size(4, "cpu") == 4
    with pytest.raises(TypeError):
        world_size([0, 1], "cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert world_size(None, "cpu") == world_size(3, "cpu") == 3
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        world_size(2, "cpu")


def test_loop_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node=2 over loop.main
    on the CPU: the launcher's two ranks (gloo, env:// rendezvous on a
    port the launcher picks), one CSV and rank 0's checkpoints; rank 0
    alone prints."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from fixtures import make_multiflow_sample
    from test_torch_train_cli import HW, mf_args, read_rows

    root = tmp_path / "data"
    for split in ("train", "val"):
        for i in range(2):
            make_multiflow_sample(root / split, f"seq_{i:04d}", height=HW[0],
                                  width=HW[1], n_events=20000,
                                  seed=3 * i + len(split))
    script = tmp_path / "train_cpu.py"
    script.write_text(
        "import sys\n"
        "from bflow_tpu_torch.train import loop\n"
        "out = loop.main(sys.argv[1:], device='cpu')\n"
        "print('world', out['world'], 'samples', out['samples'])\n")
    repo = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", str(script),
         *mf_args(root, tmp_path / "runs",
                  extra=["logging.only_numbers=true", "hardware.devices=2",
                         "training.limit_val_batches=0"])],
        capture_output=True, text=True, timeout=120, cwd=repo,
        env={**os.environ, "PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("world 2 samples 2") == 2
    assert run.stdout.count("training: 2 rank(s)") == 1
    run_dir = tmp_path / "runs" / "cli_multiflow_regen"
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == [
        "last.pt", "meta.json"]
    rows = read_rows(run_dir / "train_metrics.csv")
    assert len(rows) == 1 and np.isfinite(rows[0]["train/l1_multi_seq_loss"])
