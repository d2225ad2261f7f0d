"""The norm kernel of the bf16 encoders (bflow_tpu_torch/kernels/norm.py,
csrc/norm.cu).

On the CPU: its plain version against the encoders' norms as the port
computed them before the kernel, bit for bit, in both layouts; the dispatch,
which keeps f32 inputs, calls that autograd records, train-mode BatchNorm
and CPU tensors off the kernel; the fused ReLU; the launch counts that
chip_smoke.expected_launches derives. On a GPU (``-m cuda``): the kernel
against its plain version at the encoders' shapes and a ragged one, in both
layouts, and the model's forwards through it.

No JAX here, so the GPU cases run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_norm_kernel.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

import bflow_tpu_torch as bt
from bflow_tpu_torch import kernels
from bflow_tpu_torch.kernels import norm as knorm
from bflow_tpu_torch.models import extractor as text
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = ["nchw", "channels_last"]


def _inputs(layout, seed, n=2, c=16, h=9, w=11, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(n, c, h, w, generator=g) + 0.5).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _batch_norm(c, seed):
    """An eval-mode BatchNorm with drawn running statistics and affine."""
    g = torch.Generator().manual_seed(seed)
    bn = text.BatchNorm(c, eps=1e-5, momentum=0.1).eval()
    with torch.no_grad():
        bn.running_mean.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
        bn.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
    return bn


# the norms as the port computed them before the kernel
# (models/extractor.py: InstanceNorm, BatchNorm in eval mode), the ReLU a
# separate op after them
def _before_instance(x):
    xf = x.float()
    m1 = xf.mean(dim=(2, 3), keepdim=True)
    if x.dtype == torch.float32:
        var = (xf - m1).square().mean(dim=(2, 3), keepdim=True)
    else:
        m2 = xf.square().mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(m2 - m1.square(), min=0.0)
    return ((xf - m1) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def _before_batch(bn, x):
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, False, 0.0, bn.eps).to(x.dtype)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_instance_norm_is_the_encoders_norm(layout, relu):
    x = _inputs(layout, 0)
    want = _before_instance(x)
    want = F.relu(want) if relu else want
    got = knorm.instance_norm_plain(x, relu)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(text.InstanceNorm()(x, relu=relu), want)
    # on the CPU the wrapper takes the plain version, in x's layout
    out = knorm.instance_norm(x, relu)
    assert torch.equal(out, want)
    assert out.is_contiguous(memory_format=(
        torch.channels_last if layout == "channels_last"
        else torch.contiguous_format))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_batch_norm_is_the_encoders_norm(layout, relu):
    x = _inputs(layout, 1)
    bn = _batch_norm(16, 2)
    want = _before_batch(bn, x)
    want = F.relu(want) if relu else want
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        assert torch.equal(knorm.batch_norm_plain(x, *stats, relu), want)
        assert torch.equal(bn(x, relu=relu), want)
        assert torch.equal(knorm.batch_norm(x, *stats, relu), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["group", "batch", "instance", "none"])
def test_relu_flag_is_relu_after_the_norm(kind, dtype):
    x = _inputs("channels_last", 3, c=32, dtype=dtype)
    norm = text.make_norm(kind, 32, 4).eval()
    with torch.no_grad():
        want = F.relu(norm(x))
        got = norm(x, relu=True)
    assert got.dtype == dtype and torch.equal(got, want)


def test_f32_instance_norm_unchanged():
    """f32 keeps its two-pass variance (the JAX parity mode)."""
    x = _inputs("nchw", 4, dtype=torch.float32)
    assert torch.equal(text.InstanceNorm()(x), _before_instance(x))


class _Spy:
    """Stands in for the kernel wrappers and records who reached them."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("instance_norm", "batch_norm"):
            plain = getattr(knorm, f"{name}_plain")
            monkeypatch.setattr(knorm, name, self._wrap(name, plain))

    def _wrap(self, name, plain):
        def fn(*args, **kwargs):
            self.calls.append(name)
            return plain(*args, **kwargs)
        return fn


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor passes the gate's device test; the kernel wrappers are
    spies that run the plain versions."""
    monkeypatch.setattr(knorm, "_on_card", lambda x: True)
    return _Spy(monkeypatch)


def test_dispatch_takes_the_kernel_in_bf16_inference(on_card):
    x = _inputs("channels_last", 5)
    bn = _batch_norm(16, 6)
    with torch.no_grad():
        got_i = text.InstanceNorm()(x, relu=True)
        got_b = bn(x, relu=True)
    assert on_card.calls == ["instance_norm", "batch_norm"]
    assert torch.equal(got_i, F.relu(_before_instance(x)))
    assert torch.equal(got_b, F.relu(_before_batch(bn, x)))
    # grad mode on, but nothing that autograd would record
    on_card.calls.clear()
    text.InstanceNorm()(x)
    assert on_card.calls == ["instance_norm"]


def test_dispatch_keeps_f32_training_and_odd_channels_off(on_card):
    bn = _batch_norm(16, 7)
    x32 = _inputs("channels_last", 8, dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(text.InstanceNorm()(x32), _before_instance(x32))
        assert torch.equal(bn(x32), _before_batch(bn, x32))
    # autograd records: the input or the BatchNorm's parameters need grad
    x = _inputs("channels_last", 9).requires_grad_(True)
    y = text.InstanceNorm()(x, relu=True)
    assert torch.equal(y, F.relu(_before_instance(x.detach())))
    y.float().sum().backward()
    assert x.grad is not None
    bn(_inputs("channels_last", 10))
    # train-mode BatchNorm takes the batch's statistics, even without grad
    with torch.no_grad():
        bn.train()(_inputs("channels_last", 11))
    # a channel count the kernel does not take
    with torch.no_grad():
        x12 = _inputs("nchw", 12, c=12)
        assert torch.equal(text.InstanceNorm()(x12), _before_instance(x12))
    assert on_card.calls == []


def test_dispatch_keeps_cpu_tensors_off_the_kernel(monkeypatch):
    """On the CPU a bf16 encoder forward launches nothing and computes what
    it did before the kernel (the norms' plain versions)."""
    calls = []
    monkeypatch.setattr(knorm, "_instance_cuda",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(knorm, "_batch_cuda", lambda *a: calls.append(a))
    kernels.reset_launch_counts()
    for norm in ("instance", "batch"):
        enc = text.BasicEncoder(5, 24, norm, compute_dtype=torch.bfloat16)
        text.init_weights(enc, torch.Generator().manual_seed(0))
        with torch.no_grad():
            out = enc.eval()(_inputs("nchw", 13, n=1, c=5, h=32, w=40,
                                     dtype=torch.float32))
        assert out.dtype == torch.bfloat16 and out.shape == (1, 24, 4, 5)
    assert calls == [] and kernels.launch_counts()[knorm.NAME] == 0


@pytest.mark.parametrize("c", [4, 12, 1032])
def test_wrapper_refuses_what_the_kernel_does_not_take(c):
    x = _inputs("nchw", 14, c=c, h=3, w=4)
    assert not knorm.supported(x.shape)
    with pytest.raises(ValueError):
        knorm.instance_norm(x)
    with pytest.raises(TypeError):
        knorm.instance_norm(_inputs("nchw", 14, dtype=torch.float32))


@pytest.mark.parametrize("shape, layout, want", [
    ((80, 64, 76800), True, 14),  # fnet_ev's stage 1 at B=16
    ((16, 128, 4800), True, 32),  # cnet's stage 3: the cap
    ((1, 64, 76800), False, 4),  # NCHW at B=1: 64 planes, 16K elements each
    ((2, 16, 99), True, 1),  # too small to split
])
def test_chunks_fill_the_card(shape, layout, want):
    n, c, hw = shape
    k = knorm.chunks(n, c, hw, layout)
    assert k == want
    units, elems = (n, hw * c) if layout else (n * c, hw)
    assert k == 1 or elems // k >= knorm.MIN_BLOCK_ELEMS


def test_expected_launches_count_the_norms():
    """45 norms a bf16 E_I forward (two instance-norm encoders and cnet's
    eval BatchNorm), 30 events-only, none in f32 or in training."""
    import chip_smoke

    cfg = bt.flagship_config()
    assert chip_smoke.expected_launches(cfg)[knorm.NAME] == 45
    assert chip_smoke.expected_launches(
        cfg, train=True)[knorm.NAME] == 0
    assert chip_smoke.expected_launches(dataclasses.replace(
        cfg, use_images=False))[knorm.NAME] == 30
    assert chip_smoke.expected_launches(dataclasses.replace(
        cfg, compute_dtype="float32"))[knorm.NAME] == 0
    enc = text.BasicEncoder(5, 24, "instance")
    assert sum(isinstance(m, (text.InstanceNorm, text.BatchNorm))
               for m in enc.modules()) == 15


# ---------------------------------------------------------------------------
# on a GPU


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the norm kernel is CUDA C++ with "
                    "no CPU mode; its plain version is tested above")
    return torch.device("cuda")


# the encoders' three stages at small N, and a ragged H*W (37 x 53 = 1,961,
# odd) that no block or vector width divides
GPU_SHAPES = [(2, 64, 240, 320), (2, 96, 120, 160), (3, 128, 60, 80),
              (3, 64, 37, 53)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["instance", "batch"])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_norm_kernel_matches_plain_on_gpu(cuda_device, shape, kind, layout,
                                          relu):
    """Within one bf16 ulp of the plain version (or chip_smoke.NORM_ATOL of
    an output near 0), on at most chip_smoke.NORM_ULP_SHARE of the
    elements; a second launch bit-equal; the input's layout kept."""
    import chip_smoke

    rec = chip_smoke.check_norm(kind, *shape, layout == "channels_last",
                                seed=sum(shape), relu=relu)
    assert rec["ok"], rec


@pytest.mark.cuda
def test_norm_kernel_refuses_odd_channels_on_gpu(cuda_device):
    x = torch.randn(2, 12, 8, 8, device=cuda_device).bfloat16()
    assert not knorm.supported(x.shape)
    before = knorm.launches
    with pytest.raises(ValueError):
        knorm.instance_norm(x)
    with pytest.raises(ValueError):
        knorm.batch_norm(x, *(torch.ones(12, device=cuda_device),) * 4, 1e-5)
    assert knorm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("opt_in", [False, True])
def test_encoders_run_every_norm_through_the_kernel_on_gpu(cuda_device,
                                                           opt_in):
    """A bf16 forward launches the norm kernel 45 times (both layouts: the
    conv kernels hand it channels-last, cuDNN NCHW), matches the same
    forward on the plain twins, and an f32 or training forward launches it
    never."""
    import chip_smoke

    cfg = chip_smoke.opt_in_config() if opt_in else bt.flagship_config()
    voxel = torch.randn(1, 64, 96, cfg.nbins_total, device=cuda_device)
    images = torch.rand(2, 1, 64, 96, 3, device=cuda_device) * 255
    model = chip_smoke.damp_head(bt.build_model(cfg, device="cuda"))
    kernels.reset_launch_counts()
    _, up = model(voxel, images, iters=2, test_mode=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[knorm.NAME] == 45
    with chip_smoke.plain_twins():
        _, twin = model(voxel, images, iters=2, test_mode=True)
    err = ((up.params.float() - twin.params.float()).abs().max()
           / twin.params.float().abs().max())
    assert err < 5e-2, err.item()
    f32 = bt.build_model(dataclasses.replace(
        cfg, compute_dtype="float32", corr_precision="float32",
        lookup_method="pallas", pallas_conv=False, pallas_stem=False),
        device="cuda")
    train = bt.build_model(dataclasses.replace(cfg, lookup_method="pallas"),
                           device="cuda").train()
    kernels.reset_launch_counts()
    f32(voxel, images, iters=2, test_mode=True)
    train(voxel, images, iters=2, test_mode=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[knorm.NAME] == 0
