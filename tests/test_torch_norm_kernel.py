"""The norm kernel of the encoders in inference, bf16 and f32
(bflow_tpu_torch/kernels/norm.py, csrc/norm.cu).

On the CPU: its plain version against the encoders' norms as the port
computed them before the kernel, bit for bit, in both layouts and both
types; the dispatch, which takes bf16 and f32 inference on the card and
keeps calls that autograd records, train-mode BatchNorm, odd channel counts
and CPU tensors off the kernel; the fused ReLU; the residual block's
epilogue relu(x + y) (the plain versions, the blocks, the wrapper's choice
between the kernel's epilogue and the eager one); the launch counts that
chip_smoke.expected_launches derives; the C functions' parameters against
the ctypes signatures. On a GPU (``-m cuda``): the bf16 kernel against its
plain version at the encoders' shapes and a ragged one, in both layouts,
its residual epilogue against the eager chain bit for bit; the f32 kernel
against the eager f32 chain at every encoder norm shape of the f32 cells;
and the model's forwards through it.

No JAX here, so the GPU cases run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_norm_kernel.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import bflow_tpu_torch as bt
from bflow_tpu_torch import kernels
from bflow_tpu_torch.kernels import build as kbuild
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


def _epilogue(y, epilogue, layout, seed):
    """(relu, residual, what follows y in the encoders) for an epilogue
    case: no ReLU, the ReLU, or the residual block's: the ReLU, then
    relu(x + y) with a drawn shortcut x."""
    if epilogue != "residual":
        return epilogue, None, F.relu(y) if epilogue else y
    x = _inputs(layout, seed)
    return True, x, F.relu(x + F.relu(y))


# "residual": the ReLU, then relu(x + y) (a residual block's second norm)
EPILOGUES = [False, True, "residual"]


@pytest.mark.parametrize("relu", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_instance_norm_is_the_encoders_norm(layout, relu):
    x = _inputs(layout, 0)
    relu, res, want = _epilogue(_before_instance(x), relu, layout, 20)
    got = knorm.instance_norm_plain(x, relu, res)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(text.InstanceNorm()(x, relu=relu, residual=res), want)
    # on the CPU the wrapper takes the plain version, in x's layout
    out = knorm.instance_norm(x, relu, res)
    assert torch.equal(out, want)
    assert out.is_contiguous(memory_format=(
        torch.channels_last if layout == "channels_last"
        else torch.contiguous_format))


@pytest.mark.parametrize("relu", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_batch_norm_is_the_encoders_norm(layout, relu):
    x = _inputs(layout, 1)
    bn = _batch_norm(16, 2)
    relu, res, want = _epilogue(_before_batch(bn, x), relu, layout, 21)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        assert torch.equal(knorm.batch_norm_plain(x, *stats, relu, res),
                           want)
        assert torch.equal(bn(x, relu=relu, residual=res), want)
        assert torch.equal(knorm.batch_norm(x, *stats, relu, res), want)


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


@pytest.mark.parametrize("relu", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_f32_norms_are_the_eager_chain(layout, relu):
    """The plain versions at f32 are the eager chain the encoders ran
    before the kernel took f32 (the two-pass instance norm in f32 with its
    literal 1e-5, F.batch_norm, the ReLU, relu(x + y)), bit for bit, and
    stay f32 in x's layout."""
    x = _inputs(layout, 15, dtype=torch.float32)
    m1 = x.mean(dim=(2, 3), keepdim=True)
    var = (x - m1).square().mean(dim=(2, 3), keepdim=True)
    eager = (x - m1) * torch.rsqrt(var + 1e-5)
    relu_, res, want = _epilogue(eager, relu, layout, 22)
    if res is not None:
        res = res.float()
        want = F.relu(res + F.relu(eager))
    got = knorm.instance_norm_plain(x, relu_, res)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(knorm.instance_norm(x, relu_, res), want)
    assert got.is_contiguous(memory_format=(
        torch.channels_last if layout == "channels_last"
        else torch.contiguous_format))
    bn = _batch_norm(16, 16)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    y = F.batch_norm(x, *stats[:4], False, 0.0, bn.eps)
    want_b = (y if not relu_ else F.relu(y)) if res is None else F.relu(
        res + F.relu(y))
    with torch.no_grad():
        assert torch.equal(knorm.batch_norm_plain(x, *stats, relu_, res),
                           want_b)
        assert torch.equal(knorm.batch_norm(x, *stats, relu_, res), want_b)


class _Spy:
    """Stands in for the kernel wrappers and records who reached them,
    whether with a residual, and whether the kernel would read that
    residual in place (knorm.residual_fits)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.residuals = []
        self.fits = []
        for name in ("instance_norm", "batch_norm"):
            plain = getattr(knorm, f"{name}_plain")
            monkeypatch.setattr(knorm, name, self._wrap(name, plain))

    def _wrap(self, name, plain):
        def fn(*args, **kwargs):
            self.calls.append(name)
            bound = inspect.signature(plain).bind(*args, **kwargs)
            res = bound.arguments.get("residual")
            self.residuals.append(res is not None)
            self.fits.append(res is not None and knorm.residual_fits(
                bound.arguments["x"], res))
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


def test_dispatch_takes_the_kernel_in_f32_inference(on_card):
    """f32 inference on the card goes through the kernel too, its output
    the eager f32 chain's (the spies run the plain versions)."""
    x = _inputs("channels_last", 17, dtype=torch.float32)
    bn = _batch_norm(16, 18)
    with torch.no_grad():
        got_i = text.InstanceNorm()(x, relu=True)
        got_b = bn(x, relu=True)
    assert on_card.calls == ["instance_norm", "batch_norm"]
    assert torch.equal(got_i, F.relu(_before_instance(x)))
    assert torch.equal(got_b, F.relu(_before_batch(bn, x)))


def test_dispatch_keeps_f32_training_and_odd_channels_off(on_card):
    """Training at f32 or bf16 (autograd records the norm, or BatchNorm
    takes the batch's statistics), a channel count the kernel does not
    take and a type it does not take keep the eager code."""
    bn = _batch_norm(16, 7)
    for dtype in (torch.float32, torch.bfloat16):
        # autograd records: the input or the BatchNorm's parameters need
        # grad
        x = _inputs("channels_last", 9, dtype=dtype).requires_grad_(True)
        y = text.InstanceNorm()(x, relu=True)
        assert torch.equal(y, F.relu(_before_instance(x.detach())))
        y.float().sum().backward()
        assert x.grad is not None
        bn.eval()(_inputs("channels_last", 10, dtype=dtype))
        # train-mode BatchNorm takes the batch's statistics, even without
        # grad
        with torch.no_grad():
            bn.train()(_inputs("channels_last", 11, dtype=dtype))
        # a channel count the kernel does not take
        with torch.no_grad():
            x12 = _inputs("nchw", 12, c=12, dtype=dtype)
            assert torch.equal(text.InstanceNorm()(x12),
                               _before_instance(x12))
    with torch.no_grad():
        x64 = _inputs("nchw", 8, dtype=torch.float64)
        assert not knorm.engages(x64)
        text.InstanceNorm()(x64)
    assert on_card.calls == []


def test_dispatch_keeps_cpu_tensors_off_the_kernel(monkeypatch):
    """On the CPU a bf16 or f32 encoder forward launches nothing and
    computes what it did before the kernel (the norms' plain versions)."""
    calls = []
    monkeypatch.setattr(knorm, "_instance_cuda",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(knorm, "_batch_cuda", lambda *a: calls.append(a))
    kernels.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        for norm in ("instance", "batch"):
            enc = text.BasicEncoder(5, 24, norm, compute_dtype=dtype)
            text.init_weights(enc, torch.Generator().manual_seed(0))
            with torch.no_grad():
                out = enc.eval()(_inputs("nchw", 13, n=1, c=5, h=32, w=40,
                                         dtype=torch.float32))
            assert out.dtype == dtype and out.shape == (1, 24, 4, 5)
    assert calls == [] and kernels.launch_counts()[knorm.NAME] == 0


def _cin(stride):
    """The block's input channels: 24 beside its output where the shortcut
    is the input itself, 16 where the downsample makes it."""
    return 24 if stride == 1 else 16


def _block(norm, stride, dtype, seed):
    """A residual block (with its downsample where stride is 2) in eval
    mode, seeded weights, drawn BatchNorm statistics."""
    block = text.ResidualBlock(_cin(stride), 24, norm, stride, dtype)
    text.init_weights(block, torch.Generator().manual_seed(seed))
    for i, m in enumerate(block.modules()):
        if isinstance(m, text.BatchNorm):
            src = _batch_norm(24, seed + i)
            m.load_state_dict(src.state_dict())
    return block.eval()


def _unfused(block, x):
    """The block as the port computed it before the epilogue moved into
    the second norm: both norms, then the downsample, then relu(x + y)."""
    y = block.norm1(block.conv1(x), relu=True)
    y = block.norm2(block.conv2(y), relu=True)
    if block.downsample is not None:
        x = block.downsample(x)
    return F.relu(x + y)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm", ["instance", "batch", "group", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_block_equals_the_unfused_chain(monkeypatch, dtype, norm,
                                                 stride):
    """The block hands its shortcut to norm2, which ends with relu(x + y):
    the same tensor as the unfused chain, bit for bit, with and without a
    downsample, on the CPU and through the dispatch with the gate's device
    test passed (the kernel wrappers then run their plain versions), where
    the instance norms and eval BatchNorms of a bf16 or f32 block take
    it."""
    block = _block(norm, stride, dtype, 30 + stride)
    x = _inputs("channels_last", 31, c=_cin(stride), h=10, w=12,
                dtype=dtype)
    with torch.no_grad():
        want = _unfused(block, x)
        assert torch.equal(block(x), want)
        spy = _Spy(monkeypatch)
        monkeypatch.setattr(knorm, "_on_card", lambda t: True)
        got = block(x)
    assert got.dtype == dtype and torch.equal(got, want)
    kernel = norm in ("instance", "batch")
    # norm1, the downsample's norm, norm2 with the shortcut
    want_res = [False] * (1 + (stride == 2)) + [True]
    assert spy.residuals == (want_res if kernel else [])


def test_residual_block_backward_unchanged():
    """Training runs the eager epilogue: the block's gradients are the
    unfused chain's, bit for bit."""
    grads = []
    for fn in (lambda b, x: b(x), _unfused):
        block = _block("batch", 2, None, 40).train()
        x = _inputs("nchw", 41, c=16, h=10, w=12,
                    dtype=torch.float32).requires_grad_(True)
        fn(block, x).square().sum().backward()
        grads.append([x.grad] + [p.grad for p in block.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_residual_fits_only_in_the_inputs_layout():
    z = _inputs("channels_last", 42)
    assert knorm.residual_fits(z, _inputs("channels_last", 43))
    assert not knorm.residual_fits(z, _inputs("nchw", 43))
    assert not knorm.residual_fits(z, _inputs("channels_last", 43,
                                              dtype=torch.float32))
    assert not knorm.residual_fits(z, _inputs("channels_last", 43, w=12))
    zn = _inputs("nchw", 44)
    assert knorm.residual_fits(zn, _inputs("nchw", 45))
    assert not knorm.residual_fits(zn, _inputs("channels_last", 45))
    # a strided view is read after a copy to NCHW: an NCHW shortcut fits
    wide = _inputs("nchw", 46, w=22)
    view = wide[..., ::2]
    assert knorm._kind(view) is None
    assert knorm.residual_fits(view, _inputs("nchw", 47))


def _wrapper_with_shortcut(monkeypatch, kind, shortcut, dtype):
    """The CUDA wrapper with a stand-in launch that writes the plain
    norm's bytes (or, handed the shortcut's pointer, the fused result's)
    over a ``dtype`` input z, with a shortcut x that fits, or lies in NCHW,
    or has the other type; the C function's name it asked for."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    z = _inputs("channels_last", 50, dtype=dtype)
    bn = _batch_norm(16, 51)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    x = _inputs("channels_last", 52, dtype=dtype)
    if shortcut == "nchw":
        x = x.contiguous()
    elif shortcut == "other_type":
        x = x.to(other)
    plain = (knorm.instance_norm_plain(z, True) if kind == "instance"
             else knorm.batch_norm_plain(z, *stats, True))
    fused = F.relu(x.to(dtype) + plain)
    seen, symbols = [], []

    def launch(fn, device, x_ptr, out_ptr, res_ptr, *rest):
        seen.append(res_ptr)
        src = plain if res_ptr is None else fused
        assert res_ptr in (None, x.data_ptr())
        ctypes.memmove(out_ptr, src.data_ptr(),
                       src.element_size() * src.numel())

    monkeypatch.setattr(kbuild, "function",
                        lambda name, symbol, args: symbols.append(symbol))
    monkeypatch.setattr(kbuild, "launch", launch)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = (knorm._instance_cuda(z, True, x) if kind == "instance"
               else knorm._batch_cuda(z, *stats, True, x))
    assert torch.equal(got, F.relu(x + plain))
    assert got.dtype == torch.promote_types(x.dtype, dtype)
    fits = shortcut == "fits"
    assert seen == [x.data_ptr() if fits else None]
    counts = kernels.launch_counts()
    assert counts[knorm.NAME] == 1 and counts[knorm.RESIDUAL_NAME] == fits
    return symbols


@pytest.mark.parametrize("shortcut", ["fits", "nchw", "float32"])
@pytest.mark.parametrize("kind", ["instance", "batch"])
def test_wrapper_fuses_a_fitting_shortcut_else_adds_it_after(
        monkeypatch, kind, shortcut):
    """A bf16 z: a shortcut in z's layout and type goes to the kernel and
    counts one residual launch; another layout or type gets no pointer,
    and relu(x + y) follows the kernel as two PyTorch ops. Either way the
    block's tensor."""
    symbols = _wrapper_with_shortcut(
        monkeypatch, kind, "other_type" if shortcut == "float32"
        else shortcut, torch.bfloat16)
    assert symbols == [f"norm_{kind}_bf16"]


@pytest.mark.parametrize("shortcut", ["fits", "nchw", "other_type"])
@pytest.mark.parametrize("kind", ["instance", "batch"])
def test_wrapper_fuses_an_f32_shortcut_else_adds_it_after(
        monkeypatch, kind, shortcut):
    """The same over an f32 z: the f32 C function, an f32 shortcut in z's
    layout fused, a bf16 or NCHW one added after the kernel."""
    symbols = _wrapper_with_shortcut(monkeypatch, kind, shortcut,
                                     torch.float32)
    assert symbols == [f"norm_{kind}_f32"]


def test_dispatch_keeps_the_epilogue_eager_when_autograd_records(on_card):
    """A shortcut that autograd records keeps the whole norm off the
    kernel, in bf16 and in f32; in f32 inference the norm and its shortcut
    reach it."""
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        z = _inputs("channels_last", 53 + 3 * i, dtype=dtype)
        x = _inputs("channels_last", 54 + 3 * i,
                    dtype=dtype).requires_grad_(True)
        y = text.InstanceNorm()(z, relu=True, residual=x)
        assert torch.equal(y, F.relu(x.detach()
                                     + F.relu(_before_instance(z))))
        y.float().sum().backward()
        assert x.grad is not None
    assert on_card.calls == []
    z32 = _inputs("channels_last", 55, dtype=torch.float32)
    x32 = _inputs("channels_last", 56, dtype=torch.float32)
    with torch.no_grad():
        got = text.InstanceNorm()(z32, relu=True, residual=x32)
    assert torch.equal(got, F.relu(x32 + F.relu(_before_instance(z32))))
    assert on_card.calls == ["instance_norm"] and on_card.residuals == [True]


def _c_params(symbol):
    """The parameter types of an extern "C" function of csrc/norm.cu."""
    src = (Path(knorm.__file__).parent.parent / "csrc" / "norm.cu"
           ).read_text()
    m = re.search(rf"int {symbol}\(([^)]*)\)", src)
    return [p.rsplit(" ", 1)[0].replace("const ", "").strip()
            for p in m.group(1).split(",")]


@pytest.mark.parametrize("symbol, argtypes", [
    ("norm_instance_bf16", knorm._INSTANCE_ARGS),
    ("norm_batch_bf16", knorm._BATCH_ARGS),
    ("norm_instance_f32", knorm._INSTANCE_ARGS),
    ("norm_batch_f32", knorm._BATCH_ARGS)])
def test_ctypes_signatures_match_the_c_functions(symbol, argtypes):
    """A pointer for each pointer, an int for each int, a float for eps,
    the stream last: ctypes would pass anything else unchecked."""
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    assert [ctype[t] for t in _c_params(symbol)] == argtypes


@pytest.mark.parametrize("c", [4, 12, 1032])
def test_wrapper_refuses_what_the_kernel_does_not_take(c):
    x = _inputs("nchw", 14, c=c, h=3, w=4)
    assert not knorm.supported(x.shape)
    with pytest.raises(ValueError):
        knorm.instance_norm(x)
    # a type it has no instantiation for (bf16 and f32 it takes)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            knorm.instance_norm(_inputs("nchw", 14, dtype=dtype))


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
    """45 norms a bf16 or f32 E_I forward (two instance-norm encoders and
    cnet's eval BatchNorm), 18 of them with their block's shortcut; 30
    events-only; none in training."""
    import chip_smoke

    cfg = bt.flagship_config()
    want = chip_smoke.expected_launches
    names = (knorm.NAME, knorm.RESIDUAL_NAME)
    assert [want(cfg)[k] for k in names] == [45, 18]
    assert [want(cfg, train=True)[k] for k in names] == [0, 0]
    assert [want(dataclasses.replace(cfg, use_images=False))[k]
            for k in names] == [30, 12]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert [want(f32)[k] for k in names] == [45, 18]
    assert [want(f32, train=True)[k] for k in names] == [0, 0]
    assert [want(dataclasses.replace(f32, use_images=False))[k]
            for k in names] == [30, 12]
    enc = text.BasicEncoder(5, 24, "instance")
    assert sum(isinstance(m, (text.InstanceNorm, text.BatchNorm))
               for m in enc.modules()) == 15
    assert sum(isinstance(m, text.ResidualBlock)
               for m in enc.modules()) == 6


def test_bf16_encoders_hand_every_block_its_shortcut(on_card):
    """A bf16 E_I forward with the gate's device test passed: 45 norms
    reach the kernel wrappers, 18 of them with their block's shortcut,
    as chip_smoke.expected_launches derives."""
    import chip_smoke

    cfg = bt.flagship_config()
    model = bt.build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model(torch.randn(1, 64, 96, cfg.nbins_total),
              torch.rand(2, 1, 64, 96, 3) * 255, iters=1, test_mode=True)
    want = chip_smoke.expected_launches(cfg, 1, 64, 96, 1)
    assert len(on_card.calls) == want[knorm.NAME] == 45
    assert sum(on_card.residuals) == want[knorm.RESIDUAL_NAME] == 18


def test_f32_encoders_hand_every_block_its_shortcut(on_card):
    """The same at f32 (the f32 eval cells' precision): 45 norms reach the
    kernel wrappers, 18 with their block's shortcut, every shortcut in its
    norm input's type and layout, as expected_launches derives; a training
    forward reaches them never."""
    import chip_smoke

    cfg = dataclasses.replace(bt.flagship_config(), compute_dtype="float32",
                              corr_precision="float32")
    model = bt.build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model(torch.randn(1, 64, 96, cfg.nbins_total),
              torch.rand(2, 1, 64, 96, 3) * 255, iters=1, test_mode=True)
    want = chip_smoke.expected_launches(cfg, 1, 64, 96, 1)
    assert len(on_card.calls) == want[knorm.NAME] == 45
    assert sum(on_card.residuals) == want[knorm.RESIDUAL_NAME] == 18
    assert on_card.fits == on_card.residuals
    on_card.calls.clear()
    model.train()(torch.randn(1, 64, 96, cfg.nbins_total),
                  torch.rand(2, 1, 64, 96, 3) * 255, iters=1)
    assert on_card.calls == []


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
# (kind, N, C, H, W): every encoder norm of the f32 eval cells at B=8
# (chip_smoke.NORM_F32_SHAPES: DSEC at 480x640, fnet_ev's 40 slices,
# fnet_img's 16 frames and cnet's BatchNorm over 8; MultiFlow at 384x512,
# fnet_ev's 48), and the ragged shape with both kinds
F32_GPU_SHAPES = [
    (kind, n, c, h, w)
    for (kind, n), stages in (
        (("instance", 40), ((64, 240, 320), (96, 120, 160), (128, 60, 80))),
        (("instance", 16), ((64, 240, 320), (96, 120, 160), (128, 60, 80))),
        (("batch", 8), ((64, 240, 320), (96, 120, 160), (128, 60, 80))),
        (("instance", 48), ((64, 192, 256), (96, 96, 128), (128, 48, 64))),
        (("instance", 16), ((64, 192, 256), (96, 96, 128), (128, 48, 64))),
        (("batch", 8), ((64, 192, 256), (96, 96, 128), (128, 48, 64))))
    for c, h, w in stages] + [("instance", 3, 64, 37, 53),
                              ("batch", 3, 64, 37, 53)]


def test_f32_gpu_shapes_cover_the_f32_cells():
    """The GPU cases below take every encoder norm shape of the f32 eval
    cells that chip_smoke derives from their encoders."""
    import chip_smoke

    assert set(chip_smoke.NORM_F32_SHAPES) <= set(F32_GPU_SHAPES)
    assert len(chip_smoke.NORM_F32_SHAPES) == 18


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
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["instance", "batch"])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_norm_kernel_residual_equals_eager_chain_on_gpu(cuda_device, shape,
                                                        kind, layout):
    """The kernel with the block's epilogue against the kernel without it
    followed by PyTorch's bf16 add and ReLU: equal to the last bit, a
    second launch bit-equal, the layout kept, one residual launch a
    call."""
    import chip_smoke

    rec = chip_smoke.check_norm_residual(kind, *shape,
                                         layout == "channels_last",
                                         seed=sum(shape) + 7)
    assert rec["ok"], rec


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["plain", "relu", "residual"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind, n, c, h, w", F32_GPU_SHAPES)
def test_f32_norm_kernel_matches_eager_chain_on_gpu(cuda_device, kind, n, c,
                                                    h, w, layout, epilogue):
    """The f32 kernel against the eager f32 chain it replaces (its plain
    version, the ReLU and relu(x + y) after it): within
    chip_smoke.NORM_F32_ULPS x 2^-23 of max|eager|, the few ulp by which
    another order of the statistics' sums and another rounding of
    1/sqrt(var + eps) move an output; a second launch bit-equal; f32 in the
    input's layout; one launch (and one residual launch) a call."""
    import chip_smoke

    rec = chip_smoke.check_norm_f32(kind, n, c, h, w,
                                    layout == "channels_last",
                                    seed=n + c + h + w, epilogue=epilogue)
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
    """A bf16 forward launches the norm kernel 45 times, 18 with the
    block's shortcut (both layouts: the conv kernels hand it channels-last,
    cuDNN NCHW), and matches the same forward on the plain twins; an f32
    inference forward launches what expected_launches derives (45 norms,
    18 with the shortcut) and its flows agree with the plain twins' to
    1e-5 of their largest; a training forward launches it never."""
    import chip_smoke

    cfg = chip_smoke.opt_in_config() if opt_in else bt.flagship_config()
    voxel = torch.randn(1, 64, 96, cfg.nbins_total, device=cuda_device)
    images = torch.rand(2, 1, 64, 96, 3, device=cuda_device) * 255
    model = chip_smoke.damp_head(bt.build_model(cfg, device="cuda"))
    kernels.reset_launch_counts()
    _, up = model(voxel, images, iters=2, test_mode=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[knorm.NAME] == 45
    assert kernels.launch_counts()[knorm.RESIDUAL_NAME] == 18
    with chip_smoke.plain_twins():
        _, twin = model(voxel, images, iters=2, test_mode=True)
    err = ((up.params.float() - twin.params.float()).abs().max()
           / twin.params.float().abs().max())
    assert err < 5e-2, err.item()
    f32 = chip_smoke.damp_head(bt.build_model(dataclasses.replace(
        cfg, compute_dtype="float32", corr_precision="float32",
        lookup_method="pallas", pallas_conv=False, pallas_stem=False),
        device="cuda"))
    kernels.reset_launch_counts()
    _, up = f32(voxel, images, iters=2, test_mode=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == chip_smoke.expected_launches(f32.config, 1, 64, 96, 2)
    assert counts[knorm.NAME] == 45 and counts[knorm.RESIDUAL_NAME] == 18
    with chip_smoke.plain_twins():
        _, twin = f32(voxel, images, iters=2, test_mode=True)
    err = (up.params - twin.params).abs().max() / twin.params.abs().max()
    assert err <= 1e-5, err.item()
    train = bt.build_model(dataclasses.replace(cfg, lookup_method="pallas"),
                           device="cuda").train()
    train32 = bt.build_model(f32.config, device="cuda").train()
    kernels.reset_launch_counts()
    train(voxel, images, iters=2, test_mode=False)
    train32(voxel, images, iters=2, test_mode=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[knorm.NAME] == 0
    assert kernels.launch_counts()[knorm.RESIDUAL_NAME] == 0
