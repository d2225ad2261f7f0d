"""What the two convolution kernels share (conv3x3.py: stride 1,
stem_conv.py: stride 2): the function they compute, its gradient as the
JAX package's custom VJPs take it, the autograd.Function, the host-side
tile plan, the prepared-weight cache and the launch.

Both compute an odd-window SAME conv (padding kh//2, kw//2) plus bias in
the bf16 fast mode: bf16 operands, f32 accumulation, the f32 bias added in
f32, an optional ReLU, one rounding to bf16. Logical shapes are the port's
NCHW and OIHW. The output is channels-last in memory (a logical
(N, O, Ho, Wo) tensor in torch.channels_last strides), from the kernel and
from the plain version alike, and an input that is already channels-last
with a multiple of 8 channels goes to the kernel as it lies: a chain of
convs with norms, ReLUs and adds between them moves no layout. Their
gradient is that of the plain bf16 conv followed by a bf16 bias add
(bflow_tpu/ops/pallas/conv3x3.py:_conv_xla, stem_conv.py:_stem_xla), with
the cotangent cast to bf16: torch's conv gradient, as the JAX package
takes XLA's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from bflow_tpu_torch.utils.timers import span

# x, w, bias, out, n, cp (padded channels), h, w, o, kh, kw, relu, and the
# tile variant bm, bn, split; the stream comes last
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# the pipelined loop's (csrc/conv_pipe.cuh): the same up to relu, then bn
PIPELINED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # bytes of shared memory one block may take there
BK = 64  # the kernels' K step (csrc/conv_igemm.cuh)
# the kernels' instantiations: (output pixels, output channels) per block
# -> stages of the shared-memory ring
VARIANTS = {(64, 64): 6, (64, 96): 5, (64, 128): 4,
            (128, 64): 4, (128, 96): 4, (128, 128): 3}
SPLITS = (1, 2, 4)  # blocks of a cluster that share K
# the pipelined loop takes launches of at least this many 128-pixel tiles:
# two waves of the other loop's two blocks an SM
PIPELINED_MIN_TILES = 4 * SMS

# what the wrappers did since the last reset_counters(): copies of an
# activation into the kernels' layout, weights laid out for them, and the
# lookups of values derived from parameters (``cached``) that found their
# value or made it anew
layout_copies = 0
weight_preps = 0
cache_hits = 0
cache_misses = 0


def reset_counters() -> None:
    global layout_copies, weight_preps, cache_hits, cache_misses
    layout_copies = weight_preps = cache_hits = cache_misses = 0


def conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int, relu: bool = False) -> torch.Tensor:
    """The kernels' function in plain PyTorch: the conv of the
    bf16-rounded operands in f32, the f32 bias, ReLU, one rounding; the
    result channels-last in memory, as the kernels write it."""
    kh, kw = w.shape[2:]
    y = F.conv2d(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(),
                 b.float(), stride, (kh // 2, kw // 2))
    return (F.relu(y) if relu else y).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def conv_ref_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int, relu: bool = False) -> torch.Tensor:
    """The JAX package's XLA formulation, whose gradient the kernels
    take: the conv in bf16, then the bias rounded to bf16 is added."""
    kh, kw = w.shape[2:]
    y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None, stride,
                 (kh // 2, kw // 2)) + b.to(torch.bfloat16)[:, None, None]
    return F.relu(y) if relu else y


class ConvFn(torch.autograd.Function):
    """forward: ``fwd`` (the kernel on CUDA tensors, conv_plain on CPU
    ones); backward: the VJP of conv_ref_bf16 with the cotangent cast to
    bf16, the gradients in the inputs' own types."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, relu: bool, fwd: Callable):
        ctx.save_for_backward(x, w, b)
        ctx.stride, ctx.relu = stride, relu
        return fwd(x, w, b, stride, relu)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            y = conv_ref_bf16(*leaves, ctx.stride, ctx.relu)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype))
                         if wanted else ())
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def apply(fwd: Callable, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int, relu: bool) -> torch.Tensor:
    """``fwd`` under ConvFn where a gradient may be asked for, else
    directly: inference pays for no autograd node."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return ConvFn.apply(x, w, b, stride, relu, fwd)
    return fwd(x, w, b, stride, relu)


def check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or b.shape != (w.shape[0],):
        raise ValueError(f"want x (N, C, H, W), w (O, C, kh, kw) and b (O,),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w has {w.shape[1]} input channels, x {x.shape[1]}")
    kh, kw = w.shape[2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding needs an odd window, got {kh}x{kw}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 (the bf16 fast mode), got "
                        f"{x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if not x.device == w.device == b.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {b.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[1] * x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError(f"image of {tuple(x.shape[1:])} exceeds the "
                         f"kernel's 32-bit offsets")


# ---------------------------------------------------------------------------
# the tile plan


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One instantiation of the kernel and its grid: ``bm`` output pixels
    (64 or 128: one warpgroup per 64) and ``bn`` output channels per
    block, a ring of ``stages`` tile pairs, K shared by the ``split``
    blocks of a cluster. ``pipelined``: the 128-pixel, ``bn``-channel tiles
    go through csrc/conv_pipe.cuh's persistent loop instead (stride 1, Cp
    a multiple of 32), which lays out its own ring and splits no K, so
    such a plan carries no stages and a split of 1 (pipelined_plan)."""

    bm: int
    bn: int
    stages: int
    split: int
    pipelined: bool = False

    @property
    def threads(self) -> int:
        return 2 * self.bm

    @property
    def smem_bytes(self) -> int:
        # rows of 128 bytes, plus room to align the ring to 1,024 bytes
        return self.stages * (self.bm + self.bn) * 2 * BK + 1024

    def grid(self, m: int, o: int):
        return (-(-m // self.bm), -(-o // self.bn), self.split)

    def legal(self) -> bool:
        if self.pipelined:
            return self == pipelined_plan(self.bn) and self.bn in (64, 96, 128)
        return (VARIANTS.get((self.bm, self.bn)) == self.stages
                and self.split in SPLITS
                and self.smem_bytes <= SMEM_LIMIT)


def pipelined_plan(bn: int) -> TilePlan:
    """The pipelined loop on 128-pixel tiles of ``bn`` channels."""
    return TilePlan(128, bn, 0, 1, pipelined=True)


def all_plans():
    """Every variant the kernels are built for."""
    return [TilePlan(bm, bn, stages, split)
            for (bm, bn), stages in VARIANTS.items() for split in SPLITS]


@functools.lru_cache(maxsize=None)
def tile_plan(m: int, o: int, k: int) -> TilePlan:
    """The variant for a product of m output pixels, o output channels and
    contraction depth k (kh * kw * padded channels); the rules follow a
    sweep of every variant over the flagship's shapes on an H100.

    Two 128-pixel blocks (or two to three 64-pixel ones) fit an SM, so a
    grid runs in waves of about 2 * SMS blocks. With more than two waves
    of 128-pixel blocks, blocks are 128 pixels and the channel tile is the
    one of 64, 96, 128 that pads o least (the wider on a tie: A is
    gathered once per tile). Below that, 128 or 64 pixels, whichever fills
    its last wave better. With fewer 128-pixel blocks than SMs, blocks are
    64 pixels and the channel tile is the one that gives the most blocks
    within one wave; K is then split over 2 or 4 blocks of a cluster
    while SMs are still idle and each block keeps at least 4 steps."""
    wave = 2 * SMS

    def n_tiles(t):
        return -(-o // t)

    def least_padding(tiles):
        return min(tiles, key=lambda t: (n_tiles(t) * t, -t))

    bn = least_padding((64, 96, 128))
    t128, t64 = -(-m // 128) * n_tiles(bn), -(-m // 64) * n_tiles(bn)
    if t128 >= 2 * wave:
        bm = 128
    elif t128 >= SMS:
        fill128 = t128 / (-(-t128 // wave) * wave)
        fill64 = t64 / (-(-t64 // wave) * wave)
        bm = 128 if fill128 >= fill64 else 64
    else:
        bm = 64
        fits = [t for t in (64, 96, 128) if -(-m // 64) * n_tiles(t) <= wave]
        if fits:
            most = max(-(-m // 64) * n_tiles(t) for t in fits)
            bn = least_padding([t for t in fits
                                if -(-m // 64) * n_tiles(t) == most])
    blocks = -(-m // bm) * n_tiles(bn)
    k_tiles = -(-k // BK)
    split = 1
    while (split < SPLITS[-1] and blocks * split < SMS
           and k_tiles // (2 * split) >= 4):
        split *= 2
    return TilePlan(bm, bn, VARIANTS[(bm, bn)], split)


@functools.lru_cache(maxsize=None)
def pipelined(m: int, o: int, k: int, cp: int) -> bool:
    """Whether a stride-1 conv of m output pixels, o output channels,
    contraction depth k and cp padded input channels takes the pipelined
    loop (csrc/conv_pipe.cuh): where tile_plan gives 128-pixel tiles
    without a K split and there are at least PIPELINED_MIN_TILES of them,
    so that a persistent block a SM walks several, and its TMA boxes of 32
    or 64 channels fit cp. Every conv3x3 launch of the bf16 DSEC cell at
    batch 16 but convf1's (cp 8); at batch 1 the encoders' large maps. A
    function of the shape alone."""
    plan = tile_plan(m, o, k)
    tiles = -(-m // 128) * -(-o // plan.bn)
    return (cp % 32 == 0 and plan.bm == 128 and plan.split == 1
            and tiles >= PIPELINED_MIN_TILES)


def launch_plan(m: int, o: int, k: int, cp: int, stride: int) -> TilePlan:
    """The plan a launch runs by default: tile_plan's, or the pipelined
    loop at its channel tile where ``pipelined`` says so (stride 1 only)."""
    plan = tile_plan(m, o, k)
    if stride == 1 and pipelined(m, o, k, cp):
        return pipelined_plan(plan.bn)
    return plan


# ---------------------------------------------------------------------------
# values derived from parameters, made once per parameter value


class _Entry:
    __slots__ = ("refs", "state", "value")

    def __init__(self, refs, state, value):
        self.refs, self.state, self.value = refs, state, value


_derived: dict = {}


def cached(tag, sources: Sequence[torch.Tensor], make: Callable):
    """``make()``, remembered for as long as ``sources`` are the same
    tensor objects holding the same values: an in-place update
    (optimizer.step, load_state_dict, ``param.add_``) bumps a tensor's
    ``_version`` and a reassigned ``.data`` moves its ``data_ptr``, and
    either makes the value anew. Entries go when a source is collected.
    Making it opens the span ``bflow.conv_prep``."""
    global cache_hits, cache_misses
    key = (tag, *map(id, sources))
    state = tuple((t.data_ptr(), t._version) for t in sources)
    entry = _derived.get(key)
    if (entry is not None and entry.state == state
            and all(r() is t for r, t in zip(entry.refs, sources))):
        cache_hits += 1
        return entry.value
    cache_misses += 1
    with span("conv_prep"):
        value = make()

    def drop(_, key=key, table=_derived):  # bound now: it may run while
        table.pop(key, None)  # the interpreter shuts down, globals gone

    refs = tuple(weakref.ref(t, drop) for t in sources)
    _derived[key] = _Entry(refs, state, value)
    return value


@dataclasses.dataclass(frozen=True)
class Prepared:
    """A conv's parameters as the kernels read them: the weight as
    (O, kh, kw, Cp) bf16 with the input channels zero-padded to Cp, a
    multiple of 8, and the bias in f32."""

    w: torch.Tensor
    b: torch.Tensor
    cp: int


def _prepare(w: torch.Tensor, b: torch.Tensor) -> Prepared:
    global weight_preps
    weight_preps += 1
    c = w.shape[1]
    cp = -(-c // 8) * 8
    wk = F.pad(w.detach().to(torch.bfloat16).permute(0, 2, 3, 1),
               (0, cp - c)).contiguous()
    return Prepared(wk, b.detach().float().contiguous(), cp)


def prepared(w: torch.Tensor, b: torch.Tensor) -> Prepared:
    """The kernels' view of (w, b), reused while both are unchanged."""
    return cached("prepared", (w, b), lambda: _prepare(w, b))


# ---------------------------------------------------------------------------
# the launch


def kernel_input(x: torch.Tensor, cp: int) -> torch.Tensor:
    """x as the kernels read it: dense channels-last with cp channels,
    16-byte aligned. A tensor that already is goes through untouched;
    anything else (NCHW-contiguous, sliced, a channel count that is not a
    multiple of 8) is copied once, its channels zero-padded to cp, inside
    the span ``bflow.conv_layout``."""
    global layout_copies
    c = x.shape[1]
    if (c == cp and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0):
        return x
    layout_copies += 1
    with span("conv_layout"):
        if c == cp:
            return x.clone(memory_format=torch.channels_last)
        return F.pad(x.permute(0, 2, 3, 1), (0, cp - c)).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _launch_args(name: str, shape, o: int, kh: int, kw: int, cp: int,
                 stride: int, relu: bool, plan: Optional[TilePlan]):
    """The C function, its integer arguments and the output shape for one
    conv shape (cached: the model repeats a few dozen shapes)."""
    from bflow_tpu_torch.kernels import build

    n, _, h, wd = shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    if plan is None:
        plan = launch_plan(n * ho * wo, o, kh * kw * cp, cp, stride)
    if not plan.legal() or (plan.pipelined and (stride != 1 or cp % 32)):
        raise ValueError(f"the kernels are not built for {plan}")
    if plan.pipelined:
        fn = build.function(name, f"{name}_bf16_pipelined",
                            PIPELINED_ARGTYPES)
        ints = (n, cp, h, wd, o, kh, kw, int(relu), plan.bn)
    else:
        fn = build.function(name, f"{name}_bf16", ARGTYPES)
        ints = (n, cp, h, wd, o, kh, kw, int(relu), plan.bm, plan.bn,
                plan.split)
    return fn, ints, (n, o, ho, wo), plan


def launch_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, stride: int, relu: bool,
                plan: Optional[TilePlan] = None):
    """Launch kernel ``name`` (conv3x3: stride 1, stem_conv: stride 2) on
    CUDA tensors that passed check(); returns the (N, O, Ho, Wo) bf16
    output in channels-last strides and the TilePlan it ran. ``plan``
    forces a tile variant and loop (the tests do); by default launch_plan
    picks them."""
    from bflow_tpu_torch.kernels import build

    prep = prepared(w, b)
    xk = kernel_input(x, prep.cp)
    o, _, kh, kw = w.shape
    fn, ints, out_shape, plan = _launch_args(name, tuple(x.shape), o, kh,
                                             kw, prep.cp, stride, relu, plan)
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    build.launch(fn, x.device, xk.data_ptr(), prep.w.data_ptr(),
                 prep.b.data_ptr(), out.data_ptr(), *ints)
    return out, plan
