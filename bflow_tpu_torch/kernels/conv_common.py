"""What the two convolution kernels share (conv3x3.py: stride 1,
stem_conv.py: stride 2): the function they compute, its gradient as the
JAX package's custom VJPs take it, the autograd.Function and the launch.

Both compute an odd-window SAME conv (padding kh//2, kw//2) plus bias in
the bf16 fast mode: bf16 operands, f32 accumulation, the f32 bias added in
f32, an optional ReLU, one rounding to bf16. Layouts are the port's NCHW
and OIHW. Their gradient is that of the plain bf16 conv followed by a bf16
bias add (bflow_tpu/ops/pallas/conv3x3.py:_conv_xla, stem_conv.py:
_stem_xla), with the cotangent cast to bf16: torch's conv gradient, as the
JAX package takes XLA's.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

# x, w, bias, out, n, cp (padded channels), h, w, o, kh, kw[, relu], stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
ARGTYPES = {1: _ARGS + [ctypes.c_int, ctypes.c_void_p],
            2: _ARGS + [ctypes.c_void_p]}


def conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int, relu: bool = False) -> torch.Tensor:
    """The kernels' function in plain PyTorch: the conv of the
    bf16-rounded operands in f32, the f32 bias, ReLU, one rounding."""
    kh, kw = w.shape[2:]
    y = F.conv2d(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(),
                 b.float(), stride, (kh // 2, kw // 2))
    return (F.relu(y) if relu else y).to(torch.bfloat16)


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


def launch_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, stride: int, relu: bool) -> torch.Tensor:
    """Launch kernel ``name`` (conv3x3: stride 1, stem_conv: stride 2) on
    CUDA tensors that passed check(); returns the (N, O, Ho, Wo) bf16
    output. The kernel reads channels-last operands with the channels
    zero-padded to a multiple of 8 (16-byte copies of one tap): x and the
    weight are laid out so here, one pass over x per call, and the bias
    is taken in f32."""
    from bflow_tpu_torch.kernels import build

    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    pad = (0, -c % 8)  # channels, the last axis of the NHWC views
    xh = F.pad(x.permute(0, 2, 3, 1), pad).contiguous()
    wh = F.pad(w.to(torch.bfloat16).permute(0, 2, 3, 1), pad).contiguous()
    bf = b.float().contiguous()
    out = torch.empty((n, o, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                      dtype=torch.bfloat16, device=x.device)
    fn = build.function(name, f"{name}_bf16", ARGTYPES[stride])
    extra = (int(relu),) if stride == 1 else ()
    build.launch(fn, x.device, xh.data_ptr(), wh.data_ptr(), bf.data_ptr(),
                 out.data_ptr(), n, xh.shape[3], h, wd, o, kh, kw, *extra)
    return out
