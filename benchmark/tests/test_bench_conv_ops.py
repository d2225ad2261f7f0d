"""The conv kernels' counts (benchmark/counts/conv_ops.py) and their
readers: a launch counted by hand, the copied gates beside the port's,
the launches of a DSEC forward beside the port's own dispatch on the same
model, and the readers on traced slices made by hand."""

import dataclasses
import itertools
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.counts import conv_ops
from benchmark.counts.peaks import FLOPS, HBM_BYTES_PER_S
from benchmark.program import model_config
from benchmark.tests.conftest import small
from bflow_tpu_torch.kernels import conv3x3, stem_conv
from bflow_tpu_torch.models import RAFTSpline

CELL = "dsec_ei_bf16.eval_b16"


@pytest.mark.parametrize("launch,ops,nbytes", [
    # 2 x N Ho Wo x O x C kh kw; input (C padded 5 -> 8), weights,
    # f32 bias, output
    (conv_ops.Launch("conv3x3", "a", 2, 5, 6, 10, 32, 3, 3, 1),
     2 * 2 * 6 * 10 * 32 * 5 * 9,
     2 * 6 * 10 * 8 * 2 + 32 * 9 * 8 * 2 + 32 * 4 + 2 * 6 * 10 * 32 * 2),
    # stride 2 over an odd size: Ho = 4, Wo = 3
    (conv_ops.Launch("stem_conv", "b", 1, 16, 7, 5, 64, 7, 7, 2),
     2 * 1 * 4 * 3 * 64 * 16 * 49,
     1 * 7 * 5 * 16 * 2 + 64 * 49 * 16 * 2 + 64 * 4 + 1 * 4 * 3 * 64 * 2),
])
def test_launch_hand_counted(launch, ops, nbytes):
    assert launch.operations == ops
    assert launch.bytes == nbytes
    assert launch.bound_s == max(ops / FLOPS["bfloat16"],
                                 nbytes / HBM_BYTES_PER_S)


SHAPES = list(itertools.product((1, 4), (4, 30, 60, 120, 240), (8, 80, 640),
                                (3, 15, 64, 256, 384)))


@pytest.mark.parametrize("kh,kw,o", [(3, 3, 64), (3, 3, 16), (7, 7, 128),
                                     (1, 5, 384), (5, 1, 384), (3, 3, 256)])
def test_conv3x3_gate_is_the_ports(kh, kw, o):
    """The copied gate decides as the port's copy of the same JAX gate,
    over a grid of shapes at the flagship's sizes and around them."""
    for nhwc in SHAPES:
        assert conv_ops.conv3x3_supported(nhwc, o, kh, kw) == \
            conv3x3.supported(nhwc, torch.bfloat16, o, kh, kw), nhwc


@pytest.mark.parametrize("k", [3, 7])
def test_stem_gate_is_the_ports(k):
    for n, h, w, c in SHAPES:
        for nhwc in ((n, h, w, c), (n, h + 1, w, c), (n, 2 * h, 2 * w, c)):
            assert conv_ops.stem_supported(nhwc, k, k) == \
                stem_conv.supported(nhwc, torch.bfloat16, k, k), nhwc


def _port_launches(monkeypatch, cfg, batch, h, w, iters):
    """The conv-kernel calls the port's model makes in one forward on the
    meta device: its own dispatch (models/extractor.py:conv2d, the fused
    GRU), each kernel call recorded as (kernel, n, c, h, w, o, kh, kw,
    stride) and answered with an empty output of its shape. The gather
    lookup stands in for the lookup kernel, which has no meta path; no
    conv depends on it."""
    seen = []

    def recorder(kernel, stride):
        def call(x, wt, b, *args, **kwargs):
            n, c, hh, ww = x.shape
            o, _, kh, kw = wt.shape
            seen.append((kernel, n, c, hh, ww, o, kh, kw, stride))
            return torch.empty(n, o, (hh - 1) // stride + 1,
                               (ww - 1) // stride + 1, dtype=torch.bfloat16,
                               device=x.device)
        return call

    monkeypatch.setattr(conv3x3, "conv2d", recorder(conv_ops.CONV3X3, 1))
    monkeypatch.setattr(stem_conv, "stem_conv", recorder(conv_ops.STEM, 2))
    port_cfg = dataclasses.replace(model_config(cfg, "bfloat16", iters),
                                   lookup_method="gather")
    with torch.device("meta"):
        model = RAFTSpline(port_cfg)
    model.eval()
    bins = port_cfg.nbins_total
    with torch.no_grad():
        model(torch.empty(batch, h, w, bins, device="meta"),
              torch.empty(2, batch, h, w, 3, device="meta"))
    return Counter(seen), model.state_dict()


@pytest.mark.parametrize("batch", [1, 16])
def test_dsec_forward_launches(batch, monkeypatch):
    """At DSEC's shapes (480x640, 12 iterations) a forward launches the
    conv3x3 kernel 138 times and the stem kernel 9 times, whatever the
    batch, and each launch counted is one the port's dispatch makes on
    the same model: the same kernel on the same shapes."""
    cfg = harness.load("configs", "dsec_ei_bf16")
    port, sd = _port_launches(monkeypatch, cfg, batch, 480, 640, 12)
    found = conv_ops.launches(cfg["model"], sd, "bfloat16", batch, 480, 640,
                              12)
    counted = Counter((ln.kernel, ln.n, ln.c, ln.h, ln.w, ln.o, ln.kh, ln.kw,
                       ln.stride) for ln in found)
    assert counted == port
    per = conv_ops.per_kernel(found)
    assert per[conv_ops.CONV3X3]["launches"] == 138
    assert per[conv_ops.STEM]["launches"] == 9
    assert sum(port.values()) == 147
    # the fused GRU: one conv to 3 x 128 channels over [h, x] and one over
    # r*h, hidden to hidden; at 60x80 only the 5x1 pass's [h, x] conv
    # passes its gate
    gru = Counter((ln.what.rsplit(".", 1)[1], ln.o, ln.c)
                  for ln in found if ".gru." in ln.what)
    assert gru == {("convq1", 128, 128): 12, ("convz2", 384, 384): 12,
                   ("convq2", 128, 128): 12}


def test_f32_and_switched_off_count_nothing():
    """The f32 configuration and the bf16 one with its switches off send
    no conv to a kernel."""
    cfg = harness.load("configs", "dsec_ei_bf16")
    with torch.device("meta"):
        sd = RAFTSpline(model_config(cfg, "bfloat16", 2)).state_dict()
    assert conv_ops.launches(cfg["model"], sd, "float32", 1, 64, 80, 2) == []
    off = dict(cfg["model"], pallas_conv=False, pallas_stem=False)
    assert conv_ops.launches(off, sd, "bfloat16", 1, 64, 80, 2) == []
    stems = conv_ops.launches(dict(off, pallas_stem=True), sd, "bfloat16",
                              1, 64, 80, 2)
    assert {(ln.kernel, ln.kh) for ln in stems} == {(conv_ops.STEM, 7)}
    assert len(stems) == 3


def _name(stride, bm=128, bn=64, stages=4):
    return (f"void conv_igemm::conv_igemm_kernel<{stride}, {bm}, {bn}, "
            f"{stages}>(unsigned short const*, unsigned short const*, "
            f"float const*, __nv_bfloat16*, conv_igemm::Shape, int)")


def _run(kernels, requests=3, counts=None):
    return SimpleNamespace(
        slice={"requests": requests, "units": 16 * requests,
               "kernels": kernels},
        counts={} if counts is None else counts,
        workload=small(CELL), config=harness.load("configs", "dsec_ei_bf16"))


COUNTS = {"conv_ops": {
    conv_ops.CONV3X3: {"launches": 4, "operations": 0, "bytes": 0,
                       "bound_s": 2e-3},
    conv_ops.STEM: {"launches": 1, "operations": 0, "bytes": 0,
                    "bound_s": 5e-4}}}


def test_readers_by_hand():
    """Each reader sums its kernel's variants (by the template's stride),
    and gives the counted bound of the slice's forwards over their device
    time, in %."""
    run = _run({_name(1): [8, 0.01], _name(1, 64, 96, 5): [4, 0.005],
                _name(2): [3, 0.004], "corr_lookup_fwd_kernel": [36, 0.1]},
               counts=COUNTS)
    c3 = harness.reader("conv3x3_roofline.eval").read(run)
    st = harness.reader("stem_roofline.eval").read(run)
    assert c3 == pytest.approx(100 * 3 * 2e-3 / 0.015)
    assert st == pytest.approx(100 * 3 * 5e-4 / 0.004)


@pytest.mark.parametrize("kernels", [
    {_name(1): [11, 0.01], _name(2): [2, 0.004]},  # one launch short each
    {_name(1): [13, 0.01], _name(2): [4, 0.004]},  # one too many
    {},  # no conv kernel ran
])
def test_readers_return_none_on_a_launch_mismatch(kernels):
    run = _run(kernels, counts=COUNTS)
    for name in ("conv3x3_roofline.eval", "stem_roofline.eval"):
        assert harness.reader(name).read(run) is None
    run.slice = {}
    assert harness.reader("conv3x3_roofline.eval").read(run) is None


def test_reader_counts_the_cell_itself():
    """Without counts kept, the reader counts the cell's own forward (here
    at the small size) and keeps the count in run.counts."""
    run = _run({})
    reader = harness.reader("conv3x3_roofline.eval")
    per = reader.counted(run)
    assert run.counts["conv_ops"] is per
    n3, ns = per[conv_ops.CONV3X3]["launches"], per[conv_ops.STEM]["launches"]
    assert n3 > 0 and ns == 9
    run.slice["kernels"] = {_name(1): [3 * n3, 1.0], _name(2): [3 * ns, 1.0]}
    assert reader.read(run) == pytest.approx(
        100 * 3 * per[conv_ops.CONV3X3]["bound_s"])
