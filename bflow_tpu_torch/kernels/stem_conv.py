"""Odd-window stride-2 SAME convolution plus bias, bf16 fast mode: the CUDA
kernel's wrapper, its plain PyTorch version and the dispatch gate.

Counterpart of the TPU kernel bflow_tpu/ops/pallas/stem_conv.py:
_stem_kernel (stem_conv_pallas and its custom VJP): the encoders' 7x7/s2
stems, and under pallas_conv the 3x3/s2 convs that open stages 2 and 3.
The CUDA source is csrc/stem_conv.cu over csrc/conv_igemm.cuh;
conv_common.py holds the tile plan, the prepared-weight cache and the
launch. The output is channels-last in memory.
``supported`` is a copy of the JAX package's gate, so the model sends a
conv to the kernel exactly where the JAX package does.
"""

from __future__ import annotations

import functools

import torch

from bflow_tpu_torch.kernels.conv_common import (
    apply,
    check,
    conv_plain,
    launch_cuda,
)

NAME = "stem_conv"

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0

_K_MAX = 2048  # the TPU kernel's contraction-depth cap


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _taps(k: int):
    """Odd window k (k//2 odd) -> (tap count, top/left s2d pad)."""
    assert k % 2 == 1 and (k // 2) % 2 == 1, k
    return (k + 1) // 2, (k // 2 + 1) // 2


def _pick_ri(hs: int, ta: int) -> int:
    # ri >= ta - 1 keeps the one-block row halo inside the i+1 spec
    for cand in (16, 12, 10, 8, 6, 5, 4, 3):
        if hs % cand == 0 and cand >= ta - 1:
            return cand
    return 0


def supported(x_shape, dtype, kh: int = 7, kw: int = 7) -> bool:
    """The JAX package's gate (bflow_tpu/ops/pallas/stem_conv.py:supported)
    on the NHWC shape (N, H, W, C) of the input and the compute dtype
    (None: f32): even spatial dims, bf16, odd windows with kh//2 odd,
    contraction depth within budget."""
    n, h, w, c = x_shape
    if kh % 2 == 0 or kw % 2 == 0 or (kh // 2) % 2 == 0:
        return False
    ta, _ = _taps(kh)
    tb, _ = _taps(kw)
    k = ta * tb * 4 * _round_up(c, 16)
    return (
        dtype == torch.bfloat16
        and h % 2 == 0
        and w % 2 == 0
        and k <= _K_MAX
        and _pick_ri(h // 2, ta) > 0
    )


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The kernel's function: the stride-2 conv with bf16 operands, f32
    accumulation and the f32 bias, one rounding to bf16."""
    return conv_plain(x, w, b, 2)


def _fwd_cuda(x, w, b, stride, relu, plan=None):
    global launches
    out, _ = launch_cuda(NAME, x, w, b, stride, relu, plan)
    launches += 1
    return out


def stem_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              plan=None) -> torch.Tensor:
    """(N, C, H, W) bf16 x, (O, C, kh, kw) w, (O,) b -> (N, O, H/2, W/2)
    bf16 (ceil for odd sizes) in channels-last strides, odd kh and kw, SAME
    padding. x may lie in any layout; channels-last with C a multiple of 8
    is read in place. CUDA tensors go through the kernel (``plan``: a
    conv_common.TilePlan to force, by default conv_common.tile_plan's),
    CPU tensors through stem_conv_plain; the gradient is the plain bf16
    conv's either way (conv_common.ConvFn)."""
    check(x, w, b)
    fwd = conv_plain if x.device.type == "cpu" else _fwd_cuda
    if plan is not None and fwd is _fwd_cuda:
        fwd = functools.partial(_fwd_cuda, plan=plan)
    return apply(fwd, x, w, b, 2, False)
