"""The motion encoder's convc1 over the correlation lookups in the bf16 fast
mode: the CUDA kernel's wrapper, its plain PyTorch version and the dispatch
gate.

The function is the JAX package's fused convc1 (bflow_tpu/models/update.py
with ``fuse_corr_conv``): the (M, K) lookup map and the (256, K) weight
rounded to bf16, their products summed in f32, the f32 bias added, then the
ReLU and one rounding to bf16 (the eager chain rounds first and applies the
ReLU after; the two commute).

The kernel (csrc/corr_proj.cu) replaces no TPU kernel: the JAX package
leaves this einsum to XLA, and the source says why the port needs one. It
runs only where no gradient is asked for (it has no backward). Its output
is (M, 256) bf16, dense, which the caller views as the channels-last
(N, 256, h1, w1) map that convc2's conv kernel reads in place.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from bflow_tpu_torch.kernels.conv_common import cached

NAME = "corr_proj"

# launches since the last reset (kernels.reset_launch_counts)
launches = 0

O = 256  # output channels: the kernel's tile covers all of them
BK = 64  # csrc/corr_proj.cu: the K step the weight is padded to
ROWS = 8  # the map is read as super-rows of 8 rows: M a multiple of 8
# the weight's columns of every 16 in the order the kernel's A fragments
# hold the map's: the slots 2q, 2q + 1, 2q + 8, 2q + 9 of thread q are the
# adjacent columns 4q .. 4q + 3 (csrc/corr_proj.cu)
PERM16 = tuple(4 * (s % 8 // 2) + s % 2 + 2 * (s // 8) for s in range(16))

# x, w, bias, out, m, k, kp; the stream comes last
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def supported(x: torch.Tensor) -> bool:
    """Whether the kernel reads x as it lies: an (M, K) matrix, dense, its
    start 16-byte aligned, M a multiple of 8 (M = N * h1 * w1: 60 x 80,
    48 x 64 and 32 x 40 queries a sample at the DSEC, MultiFlow and
    streaming sizes)."""
    return (x.dim() == 2 and x.shape[0] % ROWS == 0 and x.shape[1] > 0
            and x.is_contiguous() and x.data_ptr() % 16 == 0)


def engages(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            compute_dtype) -> bool:
    """Whether convc1 over the map x goes through the kernel: a bf16 CUDA
    map in the bf16 compute type, 256 output channels, a shape the kernel
    takes, in a call that autograd would not record. Everything else (f32,
    a training forward, the CPU) takes the eager code."""
    return (_on_card(x) and x.dtype == torch.bfloat16
            and compute_dtype == torch.bfloat16 and w.shape[0] == O
            and supported(x)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (x, w, b))))


def corr_proj_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the eager chain computes
    it: the bf16-rounded operands multiplied in f32 with the f32 bias,
    rounded once to bf16, then the ReLU. w is (O, K) or (O, K, 1, 1)."""
    w2 = w.reshape(w.shape[0], -1)
    y = torch.addmm(b.float(), x.to(torch.bfloat16).float(),
                    w2.to(torch.bfloat16).float().t())
    return F.relu(y.to(torch.bfloat16))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise TypeError(f"want an (M, K) bfloat16 map, got {x.dtype} "
                        f"{tuple(x.shape)}")
    k = x.shape[1]
    if w.shape[0] != O or w[0].numel() != k or b.shape != (O,):
        raise ValueError(f"want a ({O}, {k}) weight and a ({O},) bias, got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not supported(x):
        raise ValueError(f"the kernel reads a dense, 16-byte aligned map of "
                         f"a multiple of {ROWS} rows, got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not x.device == w.device == b.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {b.device}")


def _prepare(w: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The weight as (O, Kp) bf16, its columns zero-padded to a multiple of
    BK and those of every 16 in PERM16's order, and the bias in f32."""
    w2 = w.detach().reshape(O, -1).to(torch.bfloat16)
    k = w2.shape[1]
    kp = -(-k // BK) * BK
    perm = torch.tensor(PERM16, device=w.device)
    wk = F.pad(w2, (0, kp - k)).reshape(O, kp // 16, 16)[:, :, perm]
    return wk.reshape(O, kp).contiguous(), b.detach().float().contiguous()


def _proj_cuda(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    global launches
    from bflow_tpu_torch.kernels import build

    wk, bk = cached(NAME, (w, b), lambda: _prepare(w, b))
    m, k = x.shape
    out = torch.empty((m, O), dtype=torch.bfloat16, device=x.device)
    fn = build.function(NAME, "corr_proj_bf16", _ARGTYPES)
    build.launch(fn, x.device, x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                 out.data_ptr(), m, k, wk.shape[1])
    launches += 1
    return out


def corr_proj(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 map, (256, K[, 1, 1]) weight, (256,) bias -> (M, 256)
    bf16, ReLU applied. CUDA tensors go through the kernel (their prepared
    weight made once per parameter value), CPU tensors through
    corr_proj_plain; no gradient either way (the caller checks
    ``engages``)."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return corr_proj_plain(x, w, b)
    return _proj_cuda(x, w, b)
