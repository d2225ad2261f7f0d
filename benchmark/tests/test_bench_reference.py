"""The reference against the program on the CPU, and the counts against
hand counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts.lookup_bytes import TAPS, level_bytes, patch_cells
from benchmark.program import seeded_model
from benchmark.reference.lowp import round_fp8, round_tf32
from benchmark.reference.model import Reference, flow_at
from benchmark.reference.train import voxel_grid


def _inputs(config, n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    bins = config["model"]["nbins_context"] + config["model"][
        "nbins_correlation"] - 1
    vox = torch.randn(n, h, w, bins, generator=g)
    img = torch.randint(0, 256, (2, n, h, w, 3), generator=g).float()
    return vox, img


@pytest.mark.parametrize("name", ["dsec_ei", "mf_ei"])
def test_reference_matches_program(name):
    """f32 at 64x96, B=2, 3 steps: inference (running statistics) and
    training (every step's prediction, batch statistics)."""
    config = harness.load("configs", name)
    model, sd = seeded_model(config, "float32", 5, "cpu", 3)
    vox, img = _inputs(config, 2, 64, 96, 1)
    ref = Reference(config["model"], sd)
    low, up = model(vox, img, test_mode=True)
    r_low, r_up = ref.forward(vox, img, 3)
    for got, want in ((low.params, r_low), (up.params, r_up)):
        assert (got - want).norm() / want.norm() < 1e-5
    model.train()
    preds = model(vox, img, test_mode=False)
    for p, want in zip(preds, ref.forward(vox, img, 3, train=True)):
        assert (p.params - want).norm() / want.norm() < 1e-5
    times = config["dataset"].get("supervision_times", [0.5, 1.0])
    got, want = up.flow_at(tuple(times)), flow_at(r_up, times)
    assert (got - want).norm() / want.norm() < 1e-5


def test_voxel_grid_matches_program():
    from bflow_tpu_torch.ops.voxelize import voxelize_events

    g = torch.Generator().manual_seed(3)
    n = 5000
    x = torch.randint(0, 40, (n,), generator=g, dtype=torch.int32)
    y = torch.randint(0, 30, (n,), generator=g, dtype=torch.int32)
    p = torch.randint(0, 2, (n,), generator=g).float()
    t = torch.sort(torch.randint(0, 200_000, (n,), generator=g,
                                 dtype=torch.int32)).values
    valid = torch.arange(n) < 4000
    got = voxelize_events(x, y, p, t, valid, 0, 200_000, channels=29,
                          height=30, width=40)
    want = voxel_grid(x, y, p, t, valid, 0, 200_000, 29, 30, 40)
    assert torch.allclose(got, want, atol=1e-5)


def test_roundings():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0])
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]
    y = torch.linspace(-10, 10, 101)
    err = (round_fp8(y) - y).abs().max() / 10
    assert 1e-3 < err <= 2 ** -4


@pytest.mark.parametrize("table", [
    # (hl, wl, queries (x, y), hand count of in-map patch cells)
    (10, 10, [(4.5, 4.5), (-20.0, -20.0), (9.5, 0.5)], 100 + 0 + 30),
    (3, 4, [(1.0, 1.0), (3.9, 2.9)], 12 + 12),
])
def test_lookup_bytes_hand_counts(table):
    hl, wl, queries, cells = table
    coords = torch.tensor(queries).reshape(1, 1, 1, len(queries), 2)
    assert patch_cells(hl, wl, coords) == cells
    got = level_bytes(hl, wl, coords, 2)
    assert got["fwd"] == cells * 2 + len(queries) * TAPS * 2
    assert got["bwd"] == cells * 10 + len(queries) * TAPS * 2


def test_flop_count_hand_counts():
    """One 3x3 conv and one correlation matmul of the reference, counted
    on the meta device, against 2 x multiply-adds."""
    p = {"c.weight": torch.empty(96, 64, 3, 3, device="meta"),
         "c.bias": torch.empty(96, device="meta")}
    model = {"ev_radius": 4, "img_radius": 4}
    ref = Reference(model, p)
    x = torch.empty(2, 64, 30, 40, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.conv("c", x, 2, 1)
    assert fc.get_total_flops() == 2 * 2 * 96 * 15 * 20 * 64 * 9
    a = torch.empty(5, 2, 256, 60, 80, device="meta")
    b = torch.empty(5, 2, 256, 30, 40, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.correlation(a, b)
    assert fc.get_total_flops() == 2 * 5 * 2 * (60 * 80) * (30 * 40) * 256


def test_lookup_in_row_blocks_equals_one_call(monkeypatch):
    """A volume over SAMPLE_ELEMS is sampled in row blocks: the windows and
    the volume's gradient are those of one call."""
    from benchmark.reference import model

    g = torch.Generator().manual_seed(0)
    vol = torch.randn(3, 2, 6, 7, 12, 16, generator=g, requires_grad=True)
    coords = torch.rand(3, 2, 6, 7, 2, generator=g) * 16 - 2
    ref = Reference({"ev_radius": 4, "img_radius": 4}, {})
    one = ref.lookup(vol, coords)
    (g_one,) = torch.autograd.grad(one.sum(), vol)
    monkeypatch.setattr(model, "SAMPLE_ELEMS", 1000)
    blocks = ref.lookup(vol, coords)
    (g_blocks,) = torch.autograd.grad(blocks.sum(), vol)
    assert torch.equal(one, blocks) and torch.equal(g_one, g_blocks)
