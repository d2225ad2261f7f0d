"""Feature/context encoder (RAFT BasicEncoder), NCHW.

Counterpart of bflow_tpu/models/extractor.py: 7x7 stride-2 stem, three
two-block residual stages at 64/96/128 channels (strides 1/2/2) and a 1x1
output conv, an x8 spatial downsample overall. The norm is chosen per
encoder (group / batch / instance / none). Module and parameter names are
the reference checkpoint's (``conv1``, ``norm1``, ``layer2.0.downsample.0``
...), so ``state_dict()`` lines up with the released ``net.*`` keys.

Precision follows the JAX modules' ``dtype``: parameters stay f32; with a
compute dtype, each conv casts its input, weight and bias to it at use.
Norm statistics are taken in f32 and the result is cast back. Each norm
takes ``relu``, the ReLU that follows it in the JAX modules, and
``residual``, the shortcut of a residual block's relu(x + y) after it; in
inference the instance norm and the eval-mode BatchNorm, ReLU and residual
epilogue included, are one CUDA kernel (kernels/norm.py), chosen by what
the input shows: a bf16 or f32 CUDA tensor in a call that autograd would
not record (a shortcut in another layout is added after the kernel).

The opt-in conv kernels follow the JAX package's dispatch
(bflow_tpu/models/extractor.py:Conv3x3, StemConv): under ``pallas_stem``
the 7x7/s2 stem, under ``pallas_conv`` every 3x3 (stride 1: the conv3x3
kernel, stride 2: the stem kernel) goes through a CUDA kernel wherever the
copied JAX gate passes on the input's NHWC shape; elsewhere it stays on
F.conv2d. The kernels return channels-last memory (logical NCHW), and
nothing here asks for a memory format: the norms, ReLUs, residual adds and
the F.conv2d calls between the kernels keep the layout they are given, so
each kernel reads its input in place.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from bflow_tpu_torch.kernels import conv3x3, stem_conv
from bflow_tpu_torch.kernels import norm as knorm
from bflow_tpu_torch.parallel.distributed import all_reduce_sum, is_initialized

# std of a standard normal truncated to [-2, 2]: flax's variance_scaling
# divides by it so that the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def kaiming_out_(weight: torch.Tensor,
                 generator: Optional[torch.Generator]) -> None:
    """He/Kaiming init with fan-out and gain 2, truncated normal: the JAX
    package's ``kaiming_out`` (flax variance_scaling(2, fan_out,
    truncated_normal)) on an OIHW weight."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride, padding, compute_dtype: Optional[torch.dtype],
           use_kernel: bool = False, relu: bool = False) -> torch.Tensor:
    """One SAME conv of the model, then the ReLU. With ``use_kernel`` it
    goes where the JAX package would take its Pallas kernel, as the copied
    gate decides on the NHWC shape: stride 1 to conv3x3 (the ReLU fused),
    stride 2 to stem_conv (the ReLU after it). Otherwise F.conv2d in
    ``compute_dtype`` (None: the input's own type) with the parameters
    cast at use."""
    if use_kernel:
        n, c, h, w = x.shape
        o, _, kh, kw = weight.shape
        nhwc = (n, h, w, c)
        if stride == 1 and conv3x3.supported(nhwc, compute_dtype, o, kh, kw):
            return conv3x3.conv2d(x.to(compute_dtype), weight, bias, relu)
        if stride == 2 and stem_conv.supported(nhwc, compute_dtype, kh, kw):
            out = stem_conv.stem_conv(x.to(compute_dtype), weight, bias)
            return F.relu(out) if relu else out
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    out = F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), stride, padding)
    return F.relu(out) if relu else out


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in ``compute_dtype`` (None: the input's own
    type) with its f32 parameters cast at use; ``use_kernel`` lets the
    conv take a CUDA kernel where the JAX gate passes, ``relu`` applies a
    ReLU (fused into the stride-1 kernel)."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0, compute_dtype: Optional[torch.dtype] = None,
                 use_kernel: bool = False, relu: bool = False):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.relu = relu

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # nn.Conv2d.__init__ calls this without a generator (torch's global
        # RNG); init_weights calls it again with a seeded one
        kaiming_out_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride[0],
                      self.padding, self.compute_dtype, self.use_kernel,
                      self.relu)


class Conv1x1(Conv2d):
    """1x1 conv; a strided one is a subsample followed by the 1x1 conv."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, 1, compute_dtype=compute_dtype)
        self.subsample = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.subsample != 1:
            x = x[:, :, ::self.subsample, ::self.subsample]
        return super().forward(x)


Residual = Optional[torch.Tensor]


class GroupNorm(nn.GroupNorm):
    """GroupNorm in f32, cast back, then the ReLU where ``relu`` and
    relu(residual + y) where there is a residual. F.group_norm answers
    NCHW-contiguous; a channels-last input (the conv kernels' output) gets
    its layout back in the cast, so the next conv reads it in place."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Residual = None) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        if not x.is_contiguous() and x.is_contiguous(
                memory_format=torch.channels_last):
            y = y.to(x.dtype, memory_format=torch.channels_last)
        else:
            y = y.to(x.dtype)
        return knorm.epilogue(y, relu, residual)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm as flax's nn.BatchNorm(momentum=0.9) computes it.

    Eval mode normalizes with the running statistics. Train mode
    normalizes with the batch's biased statistics in f32 and moves the
    running statistics by momentum 0.1 toward the batch's mean and its
    *biased* variance, as flax does. (nn.BatchNorm2d's own update would
    use the unbiased variance, so running_var is updated here by hand.)

    Under a process group the batch is the global one, as flax sees it
    on a sharded array: each rank sums x and x^2 per channel over its
    slice, one all-reduce of the packed sums and count gives flax's
    mean = E[x] and var = max(0, E[x^2] - E[x]^2), and the gradient
    reaches the other ranks' samples through the all-reduce's backward.
    (nn.SyncBatchNorm would also move toward the unbiased variance.)

    ``relu`` applies the ReLU after the norm, ``residual`` then
    relu(residual + y). Eval mode in bf16 or f32 inference is the norm
    kernel's (kernels/norm.py: knorm.engages)."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Residual = None) -> torch.Tensor:
        if not self.training:
            norm = (knorm.batch_norm
                    if knorm.engages(x, self.weight, self.bias, residual)
                    else knorm.batch_norm_plain)
            return norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, self.eps, relu, residual)
        xf = x.float()
        if is_initialized():
            y = self._global_batch(xf).to(x.dtype)
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
                self.num_batches_tracked.add_(1)
            y = F.batch_norm(xf, None, None, self.weight, self.bias, True,
                             0.0, self.eps).to(x.dtype)
        return knorm.epilogue(y, relu, residual)

    def _global_batch(self, xf: torch.Tensor) -> torch.Tensor:
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = all_reduce_sum(torch.cat(
            [xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


class InstanceNorm(nn.Module):
    """InstanceNorm2d with torch defaults (no affine, no running stats),
    then the ReLU where ``relu`` and relu(residual + y) where there is a
    residual.

    f32 inputs take the two-pass mean/variance; other inputs take the JAX
    fast mode's single pass, var = max(E[x^2] - E[x]^2, 0) in f32. The norm
    kernel computes either where knorm.engages (bf16 or f32 inference on
    the card), else its plain version."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Residual = None) -> torch.Tensor:
        norm = (knorm.instance_norm if knorm.engages(x, residual)
                else knorm.instance_norm_plain)
        return norm(x, relu, residual)


class NoNorm(nn.Identity):
    """No norm: x, then the ReLU where ``relu`` and relu(residual + x)
    where there is a residual."""

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Residual = None) -> torch.Tensor:
        return knorm.epilogue(x, relu, residual)


def make_norm(kind: str, channels: int, num_groups: int) -> nn.Module:
    if kind == "group":
        return GroupNorm(num_groups, channels, eps=1e-5)
    if kind == "batch":
        return BatchNorm(channels, eps=1e-5, momentum=0.1)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return NoNorm()
    raise NotImplementedError(kind)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str,
                 stride: int = 1, compute_dtype=None,
                 conv_kernel: bool = False):
        super().__init__()
        groups = planes // 8
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            compute_dtype=compute_dtype,
                            use_kernel=conv_kernel)
        self.conv2 = Conv2d(planes, planes, 3, padding=1,
                            compute_dtype=compute_dtype,
                            use_kernel=conv_kernel)
        self.norm1 = make_norm(norm, planes, groups)
        self.norm2 = make_norm(norm, planes, groups)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv1x1(in_planes, planes, stride,
                        compute_dtype=compute_dtype),
                make_norm(norm, planes, groups),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """relu(shortcut + relu(norm2(conv2(...)))): the epilogue is
        norm2's, so in inference on the card the norm kernel reads the
        shortcut and writes the block's output."""
        y = self.conv2(self.norm1(self.conv1(x), relu=True))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.norm2(y, relu=True, residual=x)


class BasicEncoder(nn.Module):
    """(N, C, H, W), or a list of such (run as one batched call) ->
    (N, output_dim, H/8, W/8), or the list of outputs. ``stem_kernel`` and
    ``conv_kernel`` are the JAX package's ``stem_pallas`` and
    ``conv_pallas``."""

    def __init__(self, input_dim: int, output_dim: int = 128,
                 norm: str = "batch", compute_dtype=None,
                 stem_kernel: bool = False, conv_kernel: bool = False):
        super().__init__()
        cdt = compute_dtype
        self.conv1 = Conv2d(input_dim, 64, 7, stride=2, padding=3,
                            compute_dtype=cdt, use_kernel=stem_kernel)
        self.norm1 = make_norm(norm, 64, 8)
        in_planes = 64
        for stage, planes in ((1, 64), (2, 96), (3, 128)):
            stride = 1 if stage == 1 else 2
            setattr(self, f"layer{stage}", nn.Sequential(
                ResidualBlock(in_planes, planes, norm, stride, cdt,
                              conv_kernel),
                ResidualBlock(planes, planes, norm, 1, cdt, conv_kernel),
            ))
            in_planes = planes
        self.conv2 = Conv1x1(128, output_dim, compute_dtype=cdt)

    def forward(
        self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
    ) -> Union[torch.Tensor, List[torch.Tensor]]:
        is_list = isinstance(x, (list, tuple))
        if is_list:
            n, parts = x[0].shape[0], len(x)
            x = torch.cat(list(x), dim=0)
        x = self.norm1(self.conv1(x), relu=True)
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if is_list:
            return list(torch.split(x, n, dim=0))
        return x


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv (kaiming_out weights, zero biases); norm
    scales start at 1 and shifts at 0, running stats at (0, 1)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator)
