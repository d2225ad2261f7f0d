"""Shared helpers of the port's parity tests (bflow_tpu vs bflow_tpu_torch),
and the config parity tests.

Both packages get identical weights and inputs: weights are drawn with
numpy into the flax variables tree (structure from jax.eval_shape, so no
JAX init is compiled) and carried to the port through
bflow_tpu_torch.weights; inputs come from np.random.default_rng(seed).
JAX is imported where it is used, so that the GPU-only tests, which import
this module, run on a machine without JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import bflow_tpu_torch as bt

# the small DSEC config of tests/test_model.py (64x64 inputs, 5 bins)
SMALL = dict(
    nbins_context=5, nbins_correlation=5, bezier_degree=2,
    use_events=True, use_images=True,
    ev_target_indices=(1, 2, 3, 4), ev_levels=(1, 1, 1, 4),
    iters_train=2, iters_test=2, lookup_method="gather",
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tier-1 run puts six pytest workers on the machine's cores;
    torch's default of one intra-op thread per core in every worker
    oversubscribes them several times over at these tiny sizes. Each
    test_torch_* module imports this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**overrides):
    """(JAX config, port config) with the same fields."""
    from bflow_tpu.models import RaftSplineConfig as JaxConfig

    kw = {**SMALL, **overrides}
    return JaxConfig(**kw), bt.RaftSplineConfig(**kw)


def random_variables(init_fn, seed: int):
    """numpy flax variables shaped like init_fn()'s, drawn from a seed:
    kaiming-scaled kernels, small nonzero biases, norm scales near 1 and
    nontrivial batch statistics."""
    import jax

    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            kh, kw, _, co = s.shape
            std = np.sqrt(2.0 / (kh * kw * co))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if name == "mean":
            return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * np.abs(rng.standard_normal(s.shape))
                    ).astype(np.float32)
        raise KeyError(path)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def damp_head(variables, factor: float = 0.02):
    """Scale the Bezier head's last kernel so random-init refinement
    behaves like a trained, contractive network
    (tests/test_precision_modes.py)."""
    head = variables["params"]["update_block"]["bezier_head"]["conv2"]
    head["kernel"] = head["kernel"] * factor
    return variables


def make_inputs(cfg, N=1, H=64, W=64, seed=0):
    rng = np.random.default_rng(seed)
    voxel = rng.standard_normal((N, H, W, cfg.nbins_total)).astype(np.float32)
    images = rng.integers(0, 255, (2, N, H, W, 3)).astype(np.float32)
    return voxel, images


def nhwc_to_nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def assert_close(got, want, rtol=1e-5, atol=1e-5):
    """assert_allclose with atol in units of max(1, max|want|): random-init
    heads reach magnitudes in the tens, where f32 summation order alone
    (XLA's convs against oneDNN's) moves the last digits."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("overrides", [
    {},
    dict(nbins_context=41, nbins_correlation=25, bezier_degree=10,
         ev_target_indices=(8, 16, 24, 32, 40), ev_levels=(1, 1, 1, 1, 4)),
    dict(use_images=False),
    dict(use_events=False),
])
def test_config_derived_properties_match(overrides):
    jc, pc = configs(**overrides)
    for prop in ("nbins_total", "levels_per_target", "num_targets",
                 "radius", "corr_planes", "lookup_timestamps"):
        assert getattr(pc, prop) == getattr(jc, prop), prop


def test_flagship_config_matches_graft_entry():
    import __graft_entry__

    want = dataclasses.asdict(__graft_entry__._flagship_config())
    got = dataclasses.asdict(bt.flagship_config())
    assert got == want


@pytest.mark.parametrize("dataset,experiment,extra", [
    # DSEC leaves the bin counts to the data; the released data has 15
    ("dsec", "dsec/raft_spline=E_I_LU4_BD2_lowpyramid",
     ["model.num_bins.context=15", "model.num_bins.correlation=15"]),
    ("multiflow_regen", "multiflow/raft_spline=E_LU5_BD10_lowpyramid", []),
])
def test_config_from_dict_matches(dataset, experiment, extra):
    from pathlib import Path

    from bflow_tpu.confsys import compose
    from bflow_tpu.models import RaftSplineConfig as JaxConfig

    config_dir = Path(__file__).resolve().parent.parent / "bflow_tpu" / "config"
    cfg = compose(config_dir, "train", [
        f"dataset={dataset}", "model=raft-spline", "dataset.path=/data",
        "wandb.group_name=t", f"+experiment/{experiment}", *extra])
    want = dataclasses.asdict(JaxConfig.from_dict(cfg["model"]))
    assert dataclasses.asdict(bt.RaftSplineConfig.from_dict(cfg["model"])) == want
