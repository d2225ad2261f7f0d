"""Port parity of the training slice: the train-mode forward, one full
train step (DSEC and MultiFlow), the optimizer and schedule, losses and
metrics, the eval step and checkpoints, against bflow_tpu on identical
weights (numpy-drawn, carried by bflow_tpu_torch.weights) and batches.

Bounds, each with its reason:
  * train forward, every iteration's upsampled Bezier params: rel 1e-4
    (the test_mode forward's bound, tests/test_torch_model.py); the
    mutated BatchNorm statistics: rel 1e-5 (one f32 reduction over the
    batch in each package);
  * loss rel 1e-5; each parameter's gradient within 1e-3 of its leaf's
    largest |grad|, or of 1e-3 of the model's largest gradient where that
    is larger: the leaves whose gradient is zero in exact arithmetic (conv
    biases in front of an instance or batch norm) hold f32 round-off in
    both packages;
  * params after the step: rel 1e-5 of the leaf's largest |param|, on the
    elements whose gradient is determined (|grad| above 1e-2 of its
    leaf's largest, ten times the gradient bound): Adam's first step is
    lr * g / (|g| + eps), so where g is round-off or within the bound of
    zero, either package may move the weight by up to lr (1 + wd |p|), and
    that is what those elements are held to;
  * a random-init ReLU network's gradient jumps where a pre-activation
    sits within f32 round-off of zero and the two packages round it to
    opposite sides (seen at 32x32 for some seeds: one element of cnet's
    layer2_0 output, 3.9e-7 against activations ~10, moved upstream
    gradients by up to 30%). The seeds below are ones where no ReLU of
    either package lands there, checked against a float64 evaluation;
  * optimizer vs optax on identical gradients: rel 1e-6; schedule vs
    onecycle_linear_schedule: rtol 1e-5, atol 1e-12 (the bound of
    tests/test_train_step.py); losses and metrics: rtol 1e-6.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bflow_tpu_torch as bt
from bflow_tpu.models import RAFTSpline as JaxRAFTSpline
from bflow_tpu.models import RaftSplineConfig as JaxConfig
from bflow_tpu.train import TaskConfig as JaxTask
from bflow_tpu.train import TrainState as JaxState
from bflow_tpu.train import build_optimizer as jax_build_optimizer
from bflow_tpu.train import make_train_step as jax_make_train_step
from bflow_tpu.train import onecycle_linear_schedule as jax_onecycle
from bflow_tpu.utils import losses as jlosses
from bflow_tpu.utils import metrics as jmetrics
from bflow_tpu_torch.train import (
    CheckpointManager,
    TaskConfig,
    TrainState,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from bflow_tpu_torch.train.checkpoint import restore_weights_only
from bflow_tpu_torch.train.step import (
    init_metric_acc,
    metric_acc_means,
    train_metric_keys,
)
from bflow_tpu_torch.utils import losses as tlosses
from bflow_tpu_torch.utils import metrics as tmetrics
from bflow_tpu_torch.weights import (
    jax_variables_from_state_dict,
    load_jax_variables,
)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_common import random_variables, rel_err

# tests/test_train_step.py's SMALL (DSEC, events + frames) and its
# MultiFlow config, f32, 2 iterations
DSEC = dict(nbins_context=5, nbins_correlation=5,
            ev_target_indices=(1, 2, 3, 4), ev_levels=(1, 1, 1, 2),
            use_images=True, iters_train=2, iters_test=2,
            lookup_method="gather")
MULTIFLOW = dict(nbins_context=11, nbins_correlation=7, bezier_degree=4,
                 ev_target_indices=(2, 4, 6, 8, 10),
                 ev_levels=(1, 1, 1, 1, 2), use_images=False,
                 iters_train=2, iters_test=2, lookup_method="gather")
MF_TIMES = (0.25, 0.5, 0.75, 1.0)
TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1, "lr_scheduler": {"use": False}}
N, H, W = 2, 32, 32


def _batch(family: str, seed: int, n=N, h=H, w=W):
    rng = np.random.default_rng(seed)
    if family == "dsec":
        return {
            "ev_repr": rng.standard_normal((n, h, w, 9)).astype(np.float32),
            "img": rng.integers(0, 255, (2, n, h, w, 3)).astype(np.float32),
            "flow": (3.0 * rng.standard_normal((n, h, w, 2))).astype(
                np.float32),
            "flow_valid": rng.random((n, h, w)) < 0.8,
        }
    return {
        "ev_repr": rng.standard_normal((n, h, w, 17)).astype(np.float32),
        "flow": (3.0 * rng.standard_normal((len(MF_TIMES), n, h, w, 2))
                 ).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tasks(family):
    if family == "dsec":
        return JaxTask("dsec"), TaskConfig("dsec")
    kw = dict(dataset="multiflow2d", multi_loss=True,
              supervision_timestamps=MF_TIMES)
    return JaxTask(**kw), TaskConfig(**kw)


def _record_grads() -> optax.GradientTransformation:
    """A pass-through optax stage that keeps the raw gradients in its
    state, so that one make_train_step also hands them out."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _run_jax(family, seed):
    """Weights, batch, and the JAX results: per-iteration predictions and
    mutated batch_stats of the train-mode forward, and the state, raw
    gradients and metrics after one make_train_step."""
    cfg = JaxConfig(**(DSEC if family == "dsec" else MULTIFLOW))
    model = JaxRAFTSpline(cfg)
    batch = _batch(family, seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0), jbatch["ev_repr"],
                           jbatch.get("img")), seed + 1)
    task, _ = _tasks(family)
    tx, _ = jax_build_optimizer(TRAINING)
    tx = optax.chain(_record_grads(), tx)
    step = jax_make_train_step(model, task, tx)

    @jax.jit
    def forward(variables, batch):
        preds, mutated = model.apply(
            variables, batch["ev_repr"], batch.get("img"),
            iters=cfg.iters_train, train=True, mutable=["batch_stats"])
        return [p.params for p in preds], mutated["batch_stats"]

    preds, bs = forward(variables, jbatch)
    state, metrics = jax.jit(step)(JaxState.create(variables, tx), jbatch)
    loss_key = ("train/l1_seq_loss" if family == "dsec"
                else "train/l1_multi_seq_loss")
    want = {"preds": preds, "batch_stats": bs, "params": state.params,
            "new_bs": state.batch_stats, "grads": state.opt_state[0],
            "metrics": metrics, "loss": metrics[loss_key][0]}
    return variables, batch, jax.tree_util.tree_map(np.asarray, want)


def _port_model(family, variables, **overrides):
    kw = {**(DSEC if family == "dsec" else MULTIFLOW), **overrides}
    model = bt.build_model(bt.RaftSplineConfig(**kw), device="cpu")
    return load_jax_variables(model, copy.deepcopy(variables))


def _run_port(family, variables, batch):
    """The port's loss and gradients (one forward/backward in train mode),
    then one make_train_step from the same weights."""
    model = _port_model(family, variables).train()
    _, task = _tasks(family)
    tb = _torch_batch(batch)
    cfg = model.config
    preds = model(tb["ev_repr"], tb.get("img"), test_mode=False)
    if family == "dsec":
        loss = tlosses.l1_seq_loss_masked(
            [p.flow_at(1.0) for p in preds], tb["flow"], tb["flow_valid"])
    else:
        loss = tlosses.l1_multi_seq_loss_masked(
            [[p.flow_at(t) for t in MF_TIMES] for p in preds],
            [tb["flow"][i] for i in range(len(MF_TIMES))])
    loss.backward()
    bstats = {k: v.clone() for k, v in model.state_dict().items()}
    # the gradients in the state_dict's layout, for the flax export
    grads = {**bstats, **{k: p.grad.clone()
                          for k, p in model.named_parameters()}}
    out = {"loss": loss.item(), "grads": grads,
           "preds": [p.params.detach().numpy() for p in preds],
           "bs_sd": bstats}
    # one full train step from the same weights and statistics
    model = _port_model(family, variables)
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    out["metrics"] = {k: (v.item(), w.item())
                      for k, (v, w) in step(tb).items()}
    out["state_dict"] = {k: v.clone() for k, v in
                         model.state_dict().items()}
    assert cfg.iters_train == len(preds)
    return out


# per family, a seed whose ReLUs sit clear of f32 round-off (docstring)
SEEDS = {"dsec": 0, "multiflow2d": 4}


@pytest.fixture(scope="module", params=["dsec", "multiflow2d"])
def family_run(request):
    family = request.param
    variables, batch, want = _run_jax(family, seed=SEEDS[family])
    got = _run_port(family, variables, batch)
    return family, variables, want, got


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _as_flax(sd):
    return jax_variables_from_state_dict(sd)


def test_train_forward_matches_jax(family_run):
    _, _, want, got = family_run
    assert len(got["preds"]) == len(want["preds"]) == 2
    for g, w in zip(got["preds"], want["preds"]):
        assert g.shape == w.shape
        assert rel_err(g, w) < 1e-4


def test_train_forward_batch_stats_match_jax(family_run):
    family, variables, want, got = family_run
    got_bs = _flat(_as_flax(got["bs_sd"])["batch_stats"])
    want_bs = _flat(want["batch_stats"])
    before = _flat(variables["batch_stats"])
    assert set(got_bs) == set(want_bs) and want_bs
    for k, w in want_bs.items():
        assert not np.allclose(w, before[k]), k  # the statistics moved
        assert rel_err(got_bs[k], w) < 1e-5, k


def test_train_loss_matches_jax(family_run):
    family, _, want, got = family_run
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    key = ("train/l1_seq_loss" if family == "dsec"
           else "train/l1_multi_seq_loss")
    np.testing.assert_allclose(got["metrics"][key][0],
                               float(want["metrics"][key][0]), rtol=1e-5)


def test_train_grads_match_jax(family_run):
    _, _, want, got = family_run
    got_g = _flat(_as_flax(got["grads"])["params"])
    want_g = _flat(want["grads"])
    assert set(got_g) == set(want_g)
    gmax = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        bound = 1e-3 * max(np.abs(w).max(), 1e-3 * gmax)
        assert np.abs(got_g[k] - w).max() <= bound, k


def test_train_step_params_match_jax(family_run):
    _, variables, want, got = family_run
    got_p = _flat(_as_flax(got["state_dict"])["params"])
    want_p = _flat(want["params"])
    before = _flat(variables["params"])
    grads = _flat(want["grads"])
    gmax = max(np.abs(g).max() for g in grads.values())
    lr, wd = TRAINING["learning_rate"], TRAINING["weight_decay"]
    for k, w in want_p.items():
        g = np.abs(grads[k])
        determined = g > max(1e-2 * g.max(), 1e-5 * gmax)
        assert determined.any() or g.max() <= 1e-3 * gmax, k
        diff = np.abs(got_p[k] - w)[determined]
        assert diff.max(initial=0.0) <= 1e-5 * np.abs(w).max(), k
        p0 = np.abs(before[k])[~determined]
        step = np.abs(got_p[k] - before[k])[~determined]
        # plus f32 rounding: of Adam's ratio and of p - step
        bound = lr * (1 + wd * p0) * (1 + 1e-6) + 2 * np.spacing(p0 + lr)
        assert (step <= bound).all(), k


def test_train_step_metrics_match_jax(family_run):
    family, _, want, got = family_run
    _, task = _tasks(family)
    assert set(got["metrics"]) == set(want["metrics"]) == set(
        train_metric_keys(task))
    for k, (v, w) in got["metrics"].items():
        wv, ww = want["metrics"][k]
        assert w == float(ww), k
        np.testing.assert_allclose(v, float(wv), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# optimizer and schedule


def test_optimizer_matches_optax_clip_adamw():
    """Identical gradients (some beyond the clamp) into optax
    clip(1) + adamw and into the port's optimizer, three steps."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3, 3, 3), (7,), (2, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(2.0 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    cfg = {**TRAINING, "lr_scheduler": {"use": True, "total_steps": 300,
                                        "pct_start": 0.01}}
    tx, _ = jax_build_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = build_optimizer(cfg, tp)
    for step_grads in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads],
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
    for got, want, before in zip(tp, jp, params):
        want = np.asarray(want)
        assert not np.allclose(want, before)
        assert rel_err(got.detach().numpy(), want) < 1e-6


def test_optimizer_keeps_b1_fixed():
    """cycle_momentum stays off: OneCycleLR must not touch Adam's b1."""
    cfg = {**TRAINING, "lr_scheduler": {"use": True, "total_steps": 100}}
    opt, sched = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    for _ in range(20):
        opt.step()
        sched.step()
        assert opt.param_groups[0]["betas"] == (0.9, 0.999)


def test_schedule_matches_jax_onecycle():
    max_lr, total, pct = 1e-4, 400, 0.01
    cfg = {"learning_rate": max_lr, "weight_decay": 1e-4,
           "lr_scheduler": {"use": True, "total_steps": total,
                            "pct_start": pct}}
    opt, sched = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])
    ours = jax_onecycle(max_lr, total + 100, pct)  # the +100 slack
    got, want = [], []
    for step in range(total + 100):
        got.append(opt.param_groups[0]["lr"])
        want.append(float(ours(step)))
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# losses and metrics


def _flows(seed, n=4, shape=(2, 6, 7, 2)):
    rng = np.random.default_rng(seed)
    return [(3.0 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(n)]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    srcs = _flows(0)
    tgt = _flows(1, n=1)[0]
    mask = np.random.default_rng(2).random(tgt.shape[:-1]) < 0.6
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    np.testing.assert_allclose(
        tlosses.l1_loss_masked(_t(srcs)[0], torch.from_numpy(tgt), tm),
        jlosses.l1_loss_masked(_j(srcs)[0], jnp.asarray(tgt), jm),
        rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.l1_seq_loss_masked(_t(srcs), torch.from_numpy(tgt), tm),
        jlosses.l1_seq_loss_masked(_j(srcs), jnp.asarray(tgt), jm),
        rtol=1e-6)
    tgts = _flows(3, n=2)
    masks = [np.random.default_rng(4 + i).random(tgt.shape[:-1]) < 0.5
             for i in range(2)]
    nested = [srcs[:2], srcs[2:]]
    np.testing.assert_allclose(
        tlosses.l1_multi_seq_loss_masked(
            [_t(s) for s in nested], _t(tgts),
            _t(masks) if masked else None, 0.7),
        jlosses.l1_multi_seq_loss_masked(
            [_j(s) for s in nested], _j(tgts),
            _j(masks) if masked else None, 0.7),
        rtol=1e-6)


def _pair_close(got, want, rtol=1e-6):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=rtol,
                               atol=1e-6)
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("masked", [False, True])
def test_single_flow_metrics_match_jax(masked):
    src, tgt = _flows(5, n=2)
    mask = np.random.default_rng(6).random(src.shape[:-1]) < 0.7
    got = tmetrics.single_flow_metrics(
        torch.from_numpy(src), torch.from_numpy(tgt),
        torch.from_numpy(mask) if masked else None)
    want = jmetrics.single_flow_metrics(
        jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(mask) if masked else None)
    assert set(got) == set(want)
    for k in want:
        _pair_close(got[k], want[k])


@pytest.mark.parametrize("gate", [None, (1.0, None), (None, 9.0)])
def test_epe_ae_multi_match_jax(gate):
    srcs, tgts = _flows(7, n=3), _flows(8, n=3)
    masks = [np.random.default_rng(9 + i).random(srcs[0].shape[:-1]) < 0.5
             for i in range(3)]
    masks[1][:] = False  # an all-invalid timestamp
    kw = {} if gate is None else dict(min_traj_len=gate[0],
                                      max_traj_len=gate[1])
    _pair_close(tmetrics.epe_multi(_t(srcs), _t(tgts), _t(masks), **kw),
                jmetrics.epe_multi(_j(srcs), _j(tgts), _j(masks), **kw))
    _pair_close(tmetrics.ae_multi(_t(srcs), _t(tgts), _t(masks)),
                jmetrics.ae_multi(_j(srcs), _j(tgts), _j(masks)))
    none = [np.zeros_like(m) for m in masks]
    got = tmetrics.ae_multi(_t(srcs), _t(tgts), _t(none))
    assert float(got[1]) == 0.0
    _pair_close(got, jmetrics.ae_multi(_j(srcs), _j(tgts), _j(none)))


@pytest.mark.parametrize("mask", ["none", "some", "empty"])
def test_l1_channel_masked_metric_matches_jax(mask):
    """The masked L1 value with a valid flag of 1, also where no pixel is
    valid."""
    src, tgt = _flows(11, n=2)
    m = {"none": None,
         "some": np.random.default_rng(12).random(src.shape[:-1]) < 0.4,
         "empty": np.zeros(src.shape[:-1], bool)}[mask]
    got = tmetrics.l1_channel_masked_metric(
        torch.from_numpy(src), torch.from_numpy(tgt),
        None if m is None else torch.from_numpy(m))
    want = jmetrics.l1_channel_masked_metric(
        jnp.asarray(src), jnp.asarray(tgt), None if m is None else
        jnp.asarray(m))
    _pair_close(got, want)
    assert float(got[1]) == 1.0


@pytest.mark.parametrize("no_top_padding", [False, True])
@pytest.mark.parametrize("hw", [(37, 53), (32, 40), (30, 39)])
def test_input_padder_matches_jax(no_top_padding, hw):
    """tests/test_padder_timers.py:29-34 for both packages: in KITTI's mode
    (no_top_padding) every padding row goes to the bottom, so the top row
    is the input's; pad and unpad equal the JAX padder's."""
    from bflow_tpu.utils.padder import InputPadder as JaxPadder

    from bflow_tpu_torch.utils.padder import InputPadder

    x = np.random.default_rng(13).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    tp = InputPadder(min_size=8, no_top_padding=no_top_padding)
    jp = JaxPadder(min_size=8, no_top_padding=no_top_padding)
    assert tp._pads(*hw) == jp._pads(*hw)
    got = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.pad(
        jnp.asarray(x))))
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    if no_top_padding:
        cols = tp._pads(*hw)[1]
        np.testing.assert_array_equal(
            got[:, 0, cols[0]:cols[0] + hw[1]].numpy(), x[:, 0])
    np.testing.assert_array_equal(tp.unpad(got, *hw).numpy(), x)


def test_lin_assumption_and_metric_bank_match_jax():
    src = _flows(10, n=1)[0]
    ts = (0.25, 0.5, 1.0)
    for g, w in zip(
            tmetrics.predictions_from_lin_assumption(
                torch.from_numpy(src), ts),
            jmetrics.predictions_from_lin_assumption(jnp.asarray(src), ts)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    tb, jb = tmetrics.MetricBank(), jmetrics.MetricBank()
    for step in range(3):
        vals = {"a": (0.1 * step + 1.0, 1.0), "b": (2.0, float(step != 1))}
        tb.update({k: (torch.tensor(v), torch.tensor(w))
                   for k, (v, w) in vals.items()})
        jb.update({k: (jnp.float32(v), jnp.float32(w))
                   for k, (v, w) in vals.items()})
    assert tb.compute() == pytest.approx(jb.compute(), rel=1e-12)
    tb.reset()
    assert tb.compute() == {}


# ---------------------------------------------------------------------------
# options of the train forward, the eval step, accumulators, checkpoints


def _small_port(seed=0, **overrides):
    kw = {**DSEC, "use_images": False, **overrides}
    return bt.build_model(bt.RaftSplineConfig(**kw), device="cpu",
                          seed=seed).train()


def _loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    preds = model(batch["ev_repr"], None, test_mode=False)
    loss = tlosses.l1_seq_loss_masked([p.flow_at(1.0) for p in preds],
                                      batch["flow"], batch["flow_valid"])
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in
                         model.named_parameters() if p.grad is not None}


def test_remat_updates_matches_plain():
    """Recomputing the update block in the backward (torch checkpoint)
    changes neither the loss nor any gradient."""
    batch = _torch_batch(_batch("dsec", 11, n=1))
    plain = _small_port()
    remat = _small_port(remat_updates=True)
    remat.load_state_dict(plain.state_dict())
    l0, g0 = _loss_and_grads(plain, batch)
    l1, g1 = _loss_and_grads(remat, batch)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    assert set(g0) == set(g1)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * g0[k].abs().max().item(),
                                   err_msg=k)


def test_detach_bezier_cuts_the_curve_gradient():
    """detach_bezier detaches the curves entering each iteration: the
    loss is unchanged, and so are the gradients with one iteration (the
    first curves are constant), but not with two."""
    batch = _torch_batch(_batch("dsec", 12, n=1))
    base = _small_port()
    det = _small_port(detach_bezier=True)
    det.load_state_dict(base.state_dict())
    for iters, same in ((1, True), (2, False)):
        base.config = dataclasses.replace(base.config, iters_train=iters)
        det.config = dataclasses.replace(det.config, iters_train=iters)
        l0, g0 = _loss_and_grads(base, batch)
        l1, g1 = _loss_and_grads(det, batch)
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        k = "update_block.bezier_head.conv2.weight"  # emits the curves
        assert torch.allclose(g1[k], g0[k]) == same, iters


def test_eval_step_pads_non_x8_inputs():
    """A 30x39 batch is padded to 32x40 for the forward and cropped
    back: the prediction and metrics match the JAX eval step."""
    from bflow_tpu.train import make_eval_step as jax_make_eval_step

    jcfg = JaxConfig(**DSEC)
    jmodel = JaxRAFTSpline(jcfg)
    batch = _batch("dsec", 13, n=1, h=30, w=39)
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 40, 9)),
                            jnp.zeros((2, 1, 32, 40, 3))), 14)
    want, want_pred, _ = jax.jit(jax_make_eval_step(jmodel, JaxTask("dsec")))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model("dsec", variables)
    model.train()  # the eval step switches to running statistics itself
    got, pred, low = make_eval_step(model, TaskConfig("dsec"))(
        _torch_batch(batch))
    assert model.training
    assert tuple(pred.shape) == (1, 30, 39, 2)
    assert tuple(low.shape) == (1, 4, 5, 2, 2)
    assert rel_err(pred.numpy(), np.asarray(want_pred)) < 1e-4
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k][0]), float(want[k][0]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_metric_accumulator_and_grad_norms():
    batch = _torch_batch(_batch("dsec", 15, n=1))
    model = _small_port()
    state = TrainState.create(model, TRAINING)
    task = TaskConfig("dsec")
    step = make_train_step(model, task, state.optimizer, state.scheduler,
                           with_grad_norms=True)
    acc = init_metric_acc(train_metric_keys(task), "cpu")
    seen = []
    for _ in range(2):
        before = copy.deepcopy(model.state_dict())
        metrics, norms = step(batch)
        seen.append({k: v.item() for k, (v, _) in metrics.items()})
        model.load_state_dict(before)  # replay the same step into acc
        state.optimizer.state.clear()
        acc, _ = step(batch, acc)
    means = metric_acc_means(acc)
    assert set(means) == set(train_metric_keys(task))
    for k, v in means.items():
        np.testing.assert_allclose(v, np.mean([s[k] for s in seen]),
                                   rtol=1e-5, err_msg=k)
    assert set(norms) == {k for k, _ in model.named_parameters()}
    vals = torch.stack(list(norms.values()))
    assert torch.isfinite(vals).all() and (vals > 0).any()


def test_checkpoint_round_trip_and_best_policy(tmp_path):
    batch = _torch_batch(_batch("dsec", 16, n=1))
    model = _small_port()
    cfg = {**TRAINING, "lr_scheduler": {"use": True, "total_steps": 50}}
    state = TrainState.create(model, cfg)
    step = make_train_step(model, TaskConfig("dsec"), state.optimizer,
                           state.scheduler)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "val/epe", "min")
    assert mgr.restore(state) is None  # nothing saved yet
    results = []
    for epe in (3.0, 2.0, 2.5):
        step(batch)
        state.step += 1
        results.append(mgr.save(state, {"val/epe": epe}))
    assert [r["improved"] for r in results] == [True, True, False]
    assert results[-1]["best_score"] == 2.0
    meta = __import__("json").loads((tmp_path / "ckpt" / "meta.json")
                                    .read_text())
    assert meta == {"best_score": 2.0, "monitor": "val/epe", "mode": "min",
                    "last_step": 3}
    # a new manager keeps the best score: 2.1 does not beat it
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), "val/epe", "min")
    assert not mgr2.save(state, {"val/epe": 2.1})["improved"]

    fresh = _small_port(seed=1)
    fresh_state = TrainState.create(fresh, cfg)
    assert mgr.restore(fresh_state, "last") is fresh_state
    assert fresh_state.step == 3
    assert fresh_state.scheduler.last_epoch == state.scheduler.last_epoch
    sd, want = fresh.state_dict(), model.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    got_opt = fresh_state.optimizer.state_dict()["state"]
    want_opt = state.optimizer.state_dict()["state"]
    assert all(torch.equal(got_opt[i]["exp_avg"], want_opt[i]["exp_avg"])
               for i in want_opt)
    # "best" is the state after the second step
    best = _small_port(seed=2)
    restore_weights_only(str(mgr.path("best")), best)
    assert not torch.equal(best.state_dict()["cnet.conv1.weight"],
                           want["cnet.conv1.weight"])


def test_restore_weights_only_reads_reference_ckpt(tmp_path):
    """A Lightning .ckpt of the reference: its net.* keys are the port's
    state_dict names."""
    src = _small_port(seed=3)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": {"net." + k: v for k, v in
                               src.state_dict().items()},
                "epoch": 7}, path)
    dst = restore_weights_only(str(path), _small_port(seed=4))
    want = src.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in dst.state_dict().items())
