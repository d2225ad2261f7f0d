"""Instance norm and eval-mode BatchNorm over bf16 activations, with an
optional fused ReLU and residual epilogue: the CUDA kernel's wrapper, its
plain PyTorch version and the dispatch gate.

The function is the JAX fast mode's norm (bflow_tpu/models/extractor.py:Norm
with a bf16 dtype): statistics in f32 over the bf16 input, the result
rounded once to bf16. The instance norm takes the single pass m1 = E[x],
var = max(E[x^2] - m1^2, 0) and (x - m1) * rsqrt(var + 1e-5); the BatchNorm
takes the running statistics, (x - mean) * (w * rsqrt(var + eps)) + b. The
ReLU, where asked, comes before the rounding, which it commutes with.

With a ``residual`` x, a residual block's epilogue follows: relu(x + y) on
the rounded y, as PyTorch computes it in x's type (for bf16 one f32 sum,
rounded once). The kernel reads x beside the norm's input where x is bf16
in that input's memory layout (``residual_fits``); otherwise the epilogue
runs as those two PyTorch ops after the kernel.

The kernel (csrc/norm.cu) replaces no TPU kernel: the JAX package leaves
this to XLA's fusion, and the source says why the port needs one. It runs
only where no gradient is asked for (it has no backward) and writes its
output in the input's memory layout, channels-last or NCHW, so the conv
kernels after it read it in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

NAME = "norm"

# norms computed by the kernel since the last reset
# (kernels.reset_launch_counts): one per call, which is two kernel launches
# for an instance norm (statistics, normalise) and one for a BatchNorm
launches = 0
# of those, the norms that took a residual (the block's epilogue fused)
residual_launches = 0
RESIDUAL_NAME = "norm_residual"

EPS = 1e-5  # the instance norm's
MAX_CHANNELS = 1024  # csrc/norm.cu: kMaxC
TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs
MIN_BLOCK_ELEMS = 16384  # what a block takes at least (32 KB of bf16)
MAX_CHUNKS = 32  # blocks a unit (sample or plane) is split over, at most

_INSTANCE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
_BATCH_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [
    ctypes.c_int] * 6 + [ctypes.c_void_p]


def supported(shape) -> bool:
    """Whether the kernel takes an (N, C, H, W) input: C a multiple of 8
    up to 1,024 (every norm of the encoders: 64, 96, 128)."""
    return len(shape) == 4 and shape[1] % 8 == 0 and 0 < shape[1] <= (
        MAX_CHANNELS)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def engages(x: torch.Tensor, *params: Optional[torch.Tensor]) -> bool:
    """Whether a norm of x (and of ``params``: BatchNorm's weight and bias,
    the residual, None where there is none) goes through the kernel: a bf16
    CUDA tensor of a supported shape, in a call that autograd would not
    record. Everything else (f32, a training forward, the CPU) takes the
    plain PyTorch path."""
    return (_on_card(x) and x.dtype == torch.bfloat16
            and supported(x.shape)
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad
                             for t in (x, *params))))


def residual_fits(x: torch.Tensor, residual: torch.Tensor) -> bool:
    """Whether the kernel reads ``residual`` in place beside x: bf16, x's
    shape and device, in the memory layout the kernel reads x in."""
    return (residual.dtype == torch.bfloat16 and residual.shape == x.shape
            and residual.device == x.device
            and _kind(residual) == (_kind(x) or "nchw"))


# ---------------------------------------------------------------------------
# the plain versions


def epilogue(y: torch.Tensor, relu: bool,
             residual: Optional[torch.Tensor]) -> torch.Tensor:
    """What follows a norm's rounded output y: the ReLU where ``relu``,
    then relu(residual + y) where there is a residual."""
    y = F.relu(y) if relu else y
    return y if residual is None else F.relu(residual + y)


def instance_norm_plain(x: torch.Tensor, relu: bool = False,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The kernel's instance norm in plain PyTorch, for any input type: f32
    statistics, the single-pass variance, one rounding to x's type, then
    the epilogue."""
    xf = x.float()
    m1 = xf.mean(dim=(2, 3), keepdim=True)
    m2 = xf.square().mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(m2 - m1.square(), min=0.0)
    return epilogue(((xf - m1) * torch.rsqrt(var + EPS)).to(x.dtype), relu,
                    residual)


def batch_norm_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     relu: bool = False,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's BatchNorm in plain PyTorch: F.batch_norm with the
    running statistics in f32, one rounding to x's type, then the
    epilogue."""
    return epilogue(F.batch_norm(x.float(), mean, var, weight, bias, False,
                                 0.0, eps).to(x.dtype), relu, residual)


# ---------------------------------------------------------------------------
# the kernel


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"want an (N, C, H, W) bfloat16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not supported(x.shape):
        raise ValueError(f"the norm kernel takes C a multiple of 8 up to "
                         f"{MAX_CHANNELS}, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def chunks(n: int, c: int, hw: int, channels_last: bool) -> int:
    """Blocks each unit is split over (a sample channels-last, a (sample,
    channel) plane in NCHW): enough for TARGET_BLOCKS in all where a block
    still gets MIN_BLOCK_ELEMS, at most MAX_CHUNKS."""
    units, elems = (n, hw * c) if channels_last else (n * c, hw)
    want = -(-TARGET_BLOCKS // max(units, 1))
    return max(1, min(want, elems // MIN_BLOCK_ELEMS, MAX_CHUNKS))


def _kind(x: torch.Tensor) -> Optional[str]:
    """The layout the kernel reads x in as it is: "nchw" (dense NCHW),
    "channels_last" (dense and 16-byte aligned), or None: it needs a
    copy."""
    if x.is_contiguous():
        return "nchw"
    if (x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0):
        return "channels_last"
    return None


def _layout(x: torch.Tensor):
    """(x as the kernel reads it, whether it is channels-last): a dense
    NCHW or a dense, 16-byte aligned channels-last tensor goes as it is;
    anything else is copied to NCHW once."""
    kind = _kind(x)
    if kind is None:
        return x.contiguous(), False
    return x, kind == "channels_last"


def _fused(x, residual):
    """(the residual the kernel reads, or None, the eager epilogue's
    residual, or None): the kernel takes it where it fits."""
    if residual is not None and residual_fits(x, residual):
        return residual, None
    return None, residual


def _counted(fused) -> None:
    global launches, residual_launches
    launches += 1
    residual_launches += fused is not None


def _instance_cuda(x: torch.Tensor, relu: bool,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    from bflow_tpu_torch.kernels import build

    fused, eager = _fused(x, residual)
    xk, cl = _layout(x)
    n, c, h, w = x.shape
    k = chunks(n, c, h * w, cl)
    out = torch.empty_like(xk)
    partial = torch.empty((n, k, 2, c), dtype=torch.float32, device=x.device)
    fn = build.function(NAME, "norm_instance_bf16", _INSTANCE_ARGS)
    build.launch(fn, x.device, xk.data_ptr(), out.data_ptr(),
                 None if fused is None else fused.data_ptr(),
                 partial.data_ptr(), n, c, h * w, int(cl), k, int(relu))
    _counted(fused)
    return epilogue(out, False, eager)


def _batch_cuda(x, mean, var, weight, bias, eps, relu, residual=None):
    from bflow_tpu_torch.kernels import build

    fused, eager = _fused(x, residual)
    xk, cl = _layout(x)
    n, c, h, w = x.shape
    params = []
    for t in (mean, var, weight, bias):
        if t.shape != (c,) or t.device != x.device:
            raise ValueError(f"want ({c},) statistics and parameters on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
        params.append(t.detach().float().contiguous())
    out = torch.empty_like(xk)
    fn = build.function(NAME, "norm_batch_bf16", _BATCH_ARGS)
    build.launch(fn, x.device, xk.data_ptr(), out.data_ptr(),
                 None if fused is None else fused.data_ptr(),
                 *(t.data_ptr() for t in params), eps, n, c, h * w, int(cl),
                 chunks(n, c, h * w, cl), int(relu))
    _counted(fused)
    return epilogue(out, False, eager)


def instance_norm(x: torch.Tensor, relu: bool = False,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C, H, W) bf16 -> the instance norm (+ ReLU, + the residual
    epilogue) in bf16, in x's memory layout. CUDA tensors go through the
    kernel, CPU tensors through instance_norm_plain; no gradient either way
    (the caller checks ``engages``)."""
    _check(x)
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu, residual)
    return _instance_cuda(x, relu, residual)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, eps: float,
               relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C, H, W) bf16 -> BatchNorm with the running statistics (+ ReLU,
    + the residual epilogue) in bf16, in x's memory layout; CUDA tensors
    through the kernel, CPU tensors through batch_norm_plain."""
    _check(x)
    if x.device.type == "cpu":
        return batch_norm_plain(x, mean, var, weight, bias, eps, relu,
                                residual)
    return _batch_cuda(x, mean, var, weight, bias, eps, relu, residual)
