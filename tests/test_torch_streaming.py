"""Port parity of the streaming entry (bflow_tpu_torch.streaming vs
examples/streaming_inference.py), on the CPU at 64x80.

The JAX example is loaded by path with its H, W and CFG patched (its
functions read them at call time) to 64x80, f32 and 2 iterations; the
same numpy-drawn flax weights go into the port through
weights.load_jax_variables. Bounds: the synthetic events bit-equal; the
voxel grid 1e-5 absolute (the same f32 arithmetic, the scatter's sums in
another order); the four query-time flows 1e-4 of max|ref| (capacity
4,096, 3,000 events).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bflow_tpu_torch import streaming
from bflow_tpu_torch.weights import load_jax_variables
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "streaming_inference.py")
HT, WD = 64, 80
CAPACITY, N = 4096, 3000
QUERY_TIMES = (0.25, 0.5, 0.75, 1.0)


@pytest.fixture(scope="module")
def jex():
    """The JAX example as a module, at 64x80, f32, 2 iterations."""
    spec = importlib.util.spec_from_file_location("jax_streaming_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.H, mod.W = HT, WD
    mod.CFG = dataclasses.replace(mod.CFG, corr_precision="float32",
                                  compute_dtype="float32", iters_test=2)
    return mod


def port_config():
    return dataclasses.replace(streaming.STREAM_CONFIG,
                               corr_precision="float32",
                               compute_dtype="float32", iters_test=2)


@pytest.fixture(scope="module")
def setup(jex):
    import jax
    import jax.numpy as jnp

    from test_torch_common import random_variables

    model, pipeline = jex.make_pipeline()
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, HT, WD, jex.CFG.nbins_total)),
                           None, test_mode=True), 5)
    events = jex.synthetic_events(np.random.default_rng(0), N)
    pad = CAPACITY - N
    valid = np.zeros(CAPACITY, bool)
    valid[:N] = True
    padded = [np.pad(a, (0, pad)) for a in events] + [valid]
    args = tuple(jnp.asarray(a) for a in padded) + (
        jnp.asarray(streaming.T0), jnp.asarray(streaming.T1))
    fn = jax.jit(lambda v, *a: pipeline(v, *a, query_times=QUERY_TIMES))
    want = np.asarray(fn(variables, *args))
    return variables, events, padded, want


def test_config_is_the_examples():
    spec = importlib.util.spec_from_file_location("jax_streaming_pristine",
                                                  EXAMPLE)
    pristine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pristine)
    assert (streaming.H, streaming.W) == (pristine.H, pristine.W)
    assert streaming.EVENT_CAPACITY == pristine.EVENT_CAPACITY
    assert (dataclasses.asdict(streaming.STREAM_CONFIG)
            == dataclasses.asdict(pristine.CFG))


@pytest.mark.parametrize("seed,n", [(0, N), (7, 300_000)])
def test_synthetic_events_bit_equal(jex, seed, n):
    want = jex.synthetic_events(np.random.default_rng(seed), n)
    got = streaming.synthetic_events(np.random.default_rng(seed), n,
                                     height=HT, width=WD)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_window_grid_matches_jax(jex, setup):
    import jax.numpy as jnp

    from bflow_tpu.ops.voxelize import voxelize_events

    _, events, padded, _ = setup
    t0, t1 = streaming.T0, streaming.T1
    want = np.asarray(voxelize_events(
        *(jnp.asarray(a) for a in padded), jnp.asarray(t0 - (t1 - t0)),
        jnp.asarray(t1), channels=jex.CFG.nbins_total, height=HT, width=WD))
    inputs = streaming.window_inputs(events, CAPACITY, "cpu")
    for a, b in zip(inputs, padded):  # padded as the example pads
        assert torch.equal(a, torch.from_numpy(b))
    got = streaming.window_grid(*inputs, channels=jex.CFG.nbins_total,
                                height=HT, width=WD)
    assert got.shape == (HT, WD, 9) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert np.abs(want).max() > 0.5  # events landed


def test_pipeline_flows_match_jax(setup):
    variables, _, padded, want = setup
    model, pipeline = streaming.make_pipeline(port_config(), HT, WD,
                                              device="cpu")
    load_jax_variables(model, variables)
    x, y, p, t, valid = (torch.from_numpy(a) for a in padded)
    got = pipeline(x, y, p, t, valid, torch.tensor(streaming.T0),
                   torch.tensor(streaming.T1), QUERY_TIMES)
    assert tuple(got.shape) == want.shape == (4, 1, HT, WD, 2)
    ref = np.abs(want).max()
    assert ref > 0
    assert np.abs(got.numpy() - want).max() <= 1e-4 * ref


def test_pipeline_reads_no_images():
    model, _ = streaming.make_pipeline(device="cpu")
    assert not hasattr(model, "fnet_img")
    assert model.cnet.conv1.weight.shape[1] == (
        streaming.STREAM_CONFIG.nbins_context)


def test_main_runs_on_cpu(monkeypatch, capsys):
    """main reads the module's H, W and EVENT_CAPACITY at call time."""
    monkeypatch.setattr(streaming, "H", HT)
    monkeypatch.setattr(streaming, "W", WD)
    monkeypatch.setattr(streaming, "EVENT_CAPACITY", CAPACITY)
    out = streaming.main(["--events", str(N), "--windows", "2"],
                         device="cpu")
    text = capsys.readouterr().out
    assert f"streaming window ({N} raw events" in text
    assert "windows/s" in text and "split (host clock" in text
    assert out["flow_shape"] == [4, 1, HT, WD, 2] and out["finite"]
    assert out["windows"] == 2 and out["ms_per_window"] > 0
    assert out["capacity"] == CAPACITY and out["size"] == [HT, WD]


def test_main_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.main(["--windows", "1"])
