"""Operand rounding for the controls: the reference run one precision below
the configuration's.

A control rounds the inputs and weights of every convolution and matrix
product to a lower format and keeps everything else in f32, as a tensor
core in that format does (operands rounded, sums in f32):

  tf32  10 mantissa bits, round to nearest even: the step below full f32
  bf16  bfloat16, round to nearest even: a bf16 configuration's own
        operand precision (the scale of its rounding error)
  fp8   float8 e4m3 with one scale per tensor (amax / 448): the step below
        bfloat16
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, nearest even (bit view)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 through float8 e4m3 with a per-tensor scale, back to f32."""
    x = x.float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).float()


ROUNDINGS = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


def rounding(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding for a control (None: full f32, identity). The
    gradient passes straight through the rounding, so a training control's
    backward products read the rounded operands its forward saved."""
    if name is None:
        return lambda x: x.float()
    fn = ROUNDINGS[name]

    def q(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.requires_grad:
            return x + (fn(x.detach()) - x.detach())
        return fn(x)

    return q
