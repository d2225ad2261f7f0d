"""The convc1 kernel of the motion encoder (bflow_tpu_torch/kernels/corr_proj.py,
csrc/corr_proj.cu).

On the CPU: its plain version against the fused convc1 as the port computed
it before the kernel, bit for bit; the dispatch, which keeps f32 maps, calls
that autograd records, the per-level lookups and CPU tensors on that eager
code, unchanged; the wrapper's refusals; the launch counts that
chip_smoke.expected_launches derives. On a GPU (``-m cuda``): the kernel
against the exact result of its function and its plain version at the
three map widths and the model's row counts, and the model's forwards
through it.

No JAX here, so the GPU cases run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_corr_proj.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

import bflow_tpu_torch as bt
from bflow_tpu_torch import kernels
from bflow_tpu_torch.kernels import corr_proj as kproj
from bflow_tpu_torch.models import update as tupd
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = [891, 972, 567]  # DSEC E_I, MultiFlow E_I, DSEC events-only


def _map(m, k, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(m, k, generator=g)).to(dtype)


def _params(k, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(256, k, 1, 1, generator=g) * (2.0 / 256) ** 0.5
    b = (2.0 * torch.rand(256, generator=g) - 1.0) / k ** 0.5
    return w, b


def _before(corr, weight, bias, corr_planes, cdt, fuse):
    """BasicMotionEncoder._corr_features as the port computed it before the
    kernel (every form, every type)."""
    w = weight.reshape(256, corr_planes)
    b = bias
    if isinstance(corr, (list, tuple)):
        _, N, h1, w1, _ = corr[0].shape
        x = torch.cat([f.permute(1, 2, 3, 0, 4).reshape(N * h1 * w1, -1)
                       for f in corr], dim=1)
        fused = True
    else:
        N, h1, w1, _ = corr.shape
        x = corr.reshape(N * h1 * w1, -1)
        fused = fuse
    if fused:
        if cdt is not None:
            w = w.to(cdt)
            x = x.to(cdt)
        y = torch.addmm(b.float(), x.float(), w.float().t())
        y = y.to(w.dtype)
    else:
        if cdt is not None:
            x, w, b = x.to(cdt), w.to(cdt), b.to(cdt)
        y = F.linear(x, w, b)
    return F.relu(y).reshape(N, h1, w1, 256).permute(0, 3, 1, 2)


def _encoder(precision, fuse=True, seed=0):
    """A motion encoder of the flagship's widths (K = 891) with drawn
    weights."""
    cfg = dataclasses.replace(bt.flagship_config(), compute_dtype=precision,
                              corr_precision=precision, fuse_corr_conv=fuse)
    enc = tupd.BasicMotionEncoder(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return enc


def _lookups(n=2, h1=4, w1=6, seed=1, dtype=torch.bfloat16):
    """The map (N, h1, w1, 891) and its per-level (Tl, N, h1, w1, 81)
    lookups, the same values."""
    g = torch.Generator().manual_seed(seed)
    per_level = [torch.randn(tl, n, h1, w1, 81, generator=g).to(dtype)
                 for tl in (5, 2, 2, 2)]
    concat = torch.cat([f.permute(1, 2, 3, 0, 4) for f in per_level],
                       dim=3).reshape(n, h1, w1, -1)
    return concat, per_level


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("m", [8, 96, 1000])
def test_plain_is_the_eager_chain(m, k):
    """corr_proj_plain, and the wrapper on CPU tensors, equal the eager
    fused chain bit for bit (bf16 map in, ReLU'd bf16 out)."""
    x = _map(m, k, m + k)
    w, b = _params(k, k)
    want = _before(x.reshape(1, 1, m, k), w, b, k, torch.bfloat16, True)
    want = want.permute(0, 2, 3, 1).reshape(m, 256)
    got = kproj.corr_proj_plain(x, w, b)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(kproj.corr_proj(x, w, b), want)
    assert torch.equal(kproj.corr_proj(x, w.reshape(256, k), b), want)
    assert 0.3 < (got == 0).float().mean().item() < 0.7  # ReLU at work


class _Spy:
    """Stands in for the kernel wrapper and records the maps it got."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kproj, "corr_proj", self._wrap)

    def _wrap(self, x, w, b):
        self.calls.append(tuple(x.shape))
        return kproj.corr_proj_plain(x, w, b)


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor passes the gate's device test; the kernel wrapper is a
    spy that runs the plain version."""
    monkeypatch.setattr(kproj, "_on_card", lambda x: True)
    return _Spy(monkeypatch)


@pytest.mark.parametrize("grad_mode", ["no_grad", "grad_on_no_leaf"])
def test_dispatch_takes_the_kernel_for_a_bf16_map(on_card, grad_mode):
    """A bf16 map in the bf16 compute type, nothing for autograd to record:
    the kernel, with the output the eager code gave, in the same
    channels-last NCHW view."""
    enc = _encoder("bfloat16").requires_grad_(False)
    concat, _ = _lookups()
    with torch.no_grad() if grad_mode == "no_grad" else torch.enable_grad():
        got = enc._corr_features(concat)
    want = _before(concat, enc.convc1.weight, enc.convc1.bias,
                   enc.corr_planes, torch.bfloat16, True)
    assert on_card.calls == [(48, 891)]
    assert torch.equal(got, want) and got.stride() == want.stride()
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", ["f32", "grad", "per_level", "unfused",
                                  "f32_map_bf16_compute", "odd_rows",
                                  "strided"])
def test_dispatch_keeps_the_eager_code(on_card, case):
    """f32, a call autograd records, the per-level lookups, the unfused
    concat form, an f32 map, a row count the kernel does not take and a
    strided map never reach the kernel, and give the parent's output bit
    for bit."""
    precision = "float32" if case == "f32" else "bfloat16"
    enc = _encoder(precision, fuse=case != "unfused")
    concat, per_level = _lookups(
        h1=3 if case == "odd_rows" else 4,
        dtype=torch.float32 if case in ("f32", "f32_map_bf16_compute")
        else torch.bfloat16)
    corr = per_level if case == "per_level" else concat
    if case == "strided":
        corr = torch.cat([concat, concat], dim=2)[:, :, ::2]
        assert not corr.is_contiguous()
    cdt = None if case == "f32" else torch.bfloat16
    ctx = torch.enable_grad() if case == "grad" else torch.no_grad()
    with ctx:
        got = enc._corr_features(corr)
        want = _before(corr, enc.convc1.weight, enc.convc1.bias,
                       enc.corr_planes, cdt, case != "unfused")
    assert on_card.calls == []
    assert torch.equal(got, want)
    if case == "grad":
        assert got.requires_grad
        got.float().sum().backward()
        assert enc.convc1.weight.grad is not None


def test_dispatch_keeps_cpu_tensors_off_the_kernel(monkeypatch):
    """On the CPU a bf16 forward launches nothing and computes what it did
    before the kernel."""
    calls = []
    monkeypatch.setattr(kproj, "_proj_cuda", lambda *a: calls.append(a))
    kernels.reset_launch_counts()
    enc = _encoder("bfloat16")
    concat, _ = _lookups()
    with torch.no_grad():
        got = enc._corr_features(concat)
    want = _before(concat, enc.convc1.weight, enc.convc1.bias,
                   enc.corr_planes, torch.bfloat16, True)
    assert torch.equal(got, want)
    assert calls == [] and kernels.launch_counts()[kproj.NAME] == 0


def test_launch_count_reads_zero_on_cpu():
    """A whole bf16 test-mode forward on the CPU: no launch counted."""
    cfg = bt.flagship_config()
    model = bt.build_model(cfg, device="cpu", seed=0)
    voxel = torch.randn(1, 64, 96, cfg.nbins_total)
    images = torch.rand(2, 1, 64, 96, 3) * 255
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(voxel, images, iters=2, test_mode=True)
    assert kernels.launch_counts()[kproj.NAME] == 0


def _bad_inputs(what):
    x, (w, b) = _map(16, 891, 0), _params(891, 0)
    if what == "f32_map":
        x = x.float()
    elif what == "3d_map":
        x = x.reshape(2, 8, 891)
    elif what == "weight_width":
        w = w[:, :890]
    elif what == "weight_rows":
        w = w[:128]
    elif what == "bias":
        b = b[:255]
    elif what == "odd_rows":
        x = x[:12]
    elif what == "strided":
        x = _map(16, 2 * 891, 0)[:, ::2]
    elif what == "unaligned":
        x = _map(17, 891, 0).reshape(-1)[1:1 + 16 * 891].reshape(16, 891)
        assert x.data_ptr() % 16 != 0
    elif what == "device":
        w = w.to("meta")
    return x, w, b


@pytest.mark.parametrize("what, error", [
    ("f32_map", TypeError), ("3d_map", TypeError),
    ("weight_width", ValueError), ("weight_rows", ValueError),
    ("bias", ValueError), ("odd_rows", ValueError), ("strided", ValueError),
    ("unaligned", ValueError), ("device", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, error):
    x, w, b = _bad_inputs(what)
    with pytest.raises(error):
        kproj.corr_proj(x, w, b)


@pytest.mark.parametrize("method", ["auto", "gather", "onehot", "pallas_q8"])
def test_expected_launches_match_the_dispatch(on_card, method):
    """chip_smoke's derivation against the dispatch itself on the CPU (the
    gate's device test passed): one launch an iteration of a bf16
    test-mode forward whose map is bf16 (the onehot method's is f32);
    none in f32 or in a forward autograd records."""
    import chip_smoke

    cfg = dataclasses.replace(bt.flagship_config(), lookup_method=method)
    model = bt.build_model(cfg, device="cpu", seed=0)
    voxel = torch.randn(1, 64, 96, cfg.nbins_total)
    images = torch.rand(2, 1, 64, 96, 3) * 255
    with torch.no_grad():
        model(voxel, images, iters=3, test_mode=True)
    want = chip_smoke.expected_launches(cfg, 1, 64, 96, 3)[kproj.NAME]
    assert len(on_card.calls) == want == (0 if method == "onehot" else 3)


def test_expected_launches_count_the_projections():
    """12 a bf16 E_I forward (and an events-only one), none in f32, in
    training or unfused."""
    import chip_smoke

    cfg = bt.flagship_config()
    want = chip_smoke.expected_launches
    assert want(cfg)[kproj.NAME] == 12
    assert want(cfg, 16, 480, 640)[kproj.NAME] == 12
    assert want(cfg, train=True)[kproj.NAME] == 0
    assert want(dataclasses.replace(cfg, use_images=False))[kproj.NAME] == 12
    assert want(dataclasses.replace(
        cfg, compute_dtype="float32", corr_precision="float32"))[
            kproj.NAME] == 0
    assert want(dataclasses.replace(cfg, fuse_corr_conv=False))[
        kproj.NAME] == 0


# ---------------------------------------------------------------------------
# on a GPU


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the convc1 kernel is CUDA C++ with "
                    "no CPU mode; its plain version is tested above")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [76800, 4800, 1280, 1000])
@pytest.mark.parametrize("k", WIDTHS)
def test_kernel_matches_plain_on_gpu(cuda_device, k, m):
    """Within one bf16 ulp of the exact result (near 0, within the f32
    sums' round-off: chip_smoke.check_corr_proj), at most
    chip_smoke.PROJ_ULP_SHARE one ulp off the plain version, ReLU's zeros
    where the exact ones are, bit-equal on a second launch."""
    import chip_smoke

    rec = chip_smoke.check_corr_proj(m, k, seed=m + k)
    assert rec["ok"], rec


@pytest.mark.cuda
def test_kernel_refuses_odd_rows_on_gpu(cuda_device):
    x = torch.randn(12, 891, device=cuda_device).bfloat16()
    w = torch.randn(256, 891, device=cuda_device)
    b = torch.zeros(256, device=cuda_device)
    before = kproj.launches
    with pytest.raises(ValueError):
        kproj.corr_proj(x, w, b)
    assert kproj.launches == before


@pytest.mark.cuda
def test_forwards_launch_the_kernel_on_gpu(cuda_device):
    """A bf16 test-mode forward launches the kernel once an iteration (12),
    matches the same forward on the plain twins, and an f32 or training
    forward launches it never."""
    import chip_smoke

    cfg = bt.flagship_config()
    voxel = torch.randn(1, 64, 96, cfg.nbins_total, device=cuda_device)
    images = torch.rand(2, 1, 64, 96, 3, device=cuda_device) * 255
    model = chip_smoke.damp_head(bt.build_model(cfg, device="cuda"))
    kernels.reset_launch_counts()
    _, up = model(voxel, images, iters=12, test_mode=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kproj.NAME] == 12
    with chip_smoke.plain_twins():
        _, twin = model(voxel, images, iters=12, test_mode=True)
    err = ((up.params.float() - twin.params.float()).abs().max()
           / twin.params.float().abs().max())
    assert err < 5e-2, err.item()
    f32 = bt.build_model(dataclasses.replace(
        cfg, compute_dtype="float32", corr_precision="float32"),
        device="cuda")
    train = bt.build_model(dataclasses.replace(cfg, lookup_method="pallas"),
                           device="cuda").train()
    kernels.reset_launch_counts()
    f32(voxel, images, iters=2, test_mode=True)
    train(voxel, images, iters=2, test_mode=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kproj.NAME] == 0
