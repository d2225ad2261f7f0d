"""Odd-window stride-1 SAME convolution plus bias with an optional fused
ReLU, bf16 fast mode: the CUDA kernel's wrapper, its plain PyTorch version
and the dispatch gate.

Counterpart of the TPU kernel bflow_tpu/ops/pallas/conv3x3.py:_kernel
(conv2d_pallas and its custom VJP). The CUDA source is csrc/conv3x3.cu
over csrc/conv_igemm.cuh; conv_common.py holds the tile plan, the
prepared-weight cache and the launch. The output is channels-last in
memory. ``supported`` is a copy of the JAX package's
gate: the model sends a conv to the kernel exactly where the JAX package
sends it to the Pallas kernel, so the two round in the same places. A
launch runs one of the kernel's two main loops (conv_common.launch_plan
picks it from the shape); both give the same bits.
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

NAME = "conv3x3"

# kernel launches since the last reset (kernels.reset_launch_counts), and
# of those the launches that took the pipelined loop (csrc/conv_pipe.cuh)
launches = 0
pipelined_launches = 0
PIPELINED_NAME = "conv3x3_pipelined"

_P_BYTES = 2_000_000  # the TPU kernel's patch scratch budget
_VMEM_BYTES = 8_000_000  # its whole working-set budget


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_ri(h: int, kh: int) -> int:
    # ri >= kh - 1 keeps the one-block row halo inside the i+1 spec
    for cand in (16, 12, 10, 8, 6, 5, 4, 3, 2):
        if h % cand == 0 and cand >= kh - 1:
            return cand
    return 0


def supported(x_shape, dtype, out_features=None, kh=3, kw=3) -> bool:
    """The JAX package's gate (bflow_tpu/ops/pallas/conv3x3.py:supported)
    on the NHWC shape (N, H, W, C) of the input and the compute dtype
    (None: f32)."""
    n, h, w, c = x_shape
    w = _round_up(w, 8)  # the wrapper pads/slices the column axis
    ri = _pick_ri(h, kh)
    if ri == 0 or dtype != torch.bfloat16:
        return False
    if out_features is not None and out_features < 32:
        return False  # tiny fan-out: the dot would idle the MXU
    k = kh * kw * c
    o = out_features or 128
    vmem = (
        4 * ri * (w + kw - 1) * c * 2  # two double-buffered row blocks
        + min(_P_BYTES, ri * w * k * 2)  # patch scratch
        + k * o * 2  # weights
        + 2 * ri * w * o * 2  # output block
    )
    return vmem < _VMEM_BYTES


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 relu: bool = False) -> torch.Tensor:
    """The kernel's function: bf16 operands, f32 accumulation, f32 bias,
    ReLU, one rounding to bf16."""
    return conv_plain(x, w, b, 1, relu)


def _fwd_cuda(x, w, b, stride, relu, plan=None):
    global launches, pipelined_launches
    out, ran = launch_cuda(NAME, x, w, b, stride, relu, plan)
    launches += 1
    pipelined_launches += ran.pipelined
    return out


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           relu: bool = False, plan=None) -> torch.Tensor:
    """(N, C, H, W) bf16 x, (O, C, kh, kw) w, (O,) b -> (N, O, H, W) bf16
    in channels-last strides, odd kh and kw, SAME padding. x may lie in
    any layout; channels-last with C a multiple of 8 is read in place.
    CUDA tensors go through the kernel (``plan``: a conv_common.TilePlan
    to force, by default conv_common.launch_plan's), CPU tensors through
    conv2d_plain; the gradient is the plain bf16 conv's either way
    (conv_common.ConvFn)."""
    check(x, w, b)
    fwd = conv_plain if x.device.type == "cpu" else _fwd_cuda
    if plan is not None and fwd is _fwd_cuda:
        fwd = functools.partial(_fwd_cuda, plan=plan)
    return apply(fwd, x, w, b, 1, relu)
