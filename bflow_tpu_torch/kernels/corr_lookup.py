"""Windowed bilinear correlation lookup, one pyramid level: CUDA kernel
wrapper and its plain PyTorch version.

Counterpart of the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:
_fwd_kernel. The CUDA source is csrc/corr_lookup_fwd.cu (its header says
what bounds it and how it is laid out). Layout, per level:

  vol     (Q, hl, wl)  each query's own correlation map, f32 or bf16
  coords  (Q, 2)       f32 positions in this level's map pixels, (x, y)
  out     (Q, (2r+1)^2) taps at (x+dx, y+dy), dy-major, in vol's type

with Q = Tl * N * h1 * w1, the all-pairs volume's own layout. The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from bflow_tpu_torch.ops.sampler import bilinear_sample

NAME = "corr_lookup_fwd"
MAX_PATCH = 16  # 2r+2 <= 16, the TPU kernel's limit as well

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns = {}


def window_offsets(radius: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """((2r+1)^2, 2) tap offsets (dx, dy), dy-major."""
    d = torch.arange(-radius, radius + 1, device=device, dtype=dtype)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def corr_lookup_level_plain(vol: torch.Tensor, coords: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """The lookup as a torch gather (the JAX package's
    _lookup_level_gather): blend in f32, round once to vol's type."""
    if vol.shape[1] == 0 or vol.shape[2] == 0:  # a pooled-away level
        return vol.new_zeros((vol.shape[0], (2 * radius + 1) ** 2))
    pts = coords[:, None, :] + window_offsets(radius, coords.device,
                                              coords.dtype)
    return bilinear_sample(vol, pts).to(vol.dtype)


def _check(vol: torch.Tensor, coords: torch.Tensor, radius: int) -> None:
    if vol.dim() != 3 or coords.dim() != 2 or coords.shape != (
            vol.shape[0], 2):
        raise ValueError(
            f"want vol (Q, hl, wl) and coords (Q, 2), got "
            f"{tuple(vol.shape)} and {tuple(coords.shape)}")
    if vol.dtype not in _DTYPES:
        raise TypeError(f"vol must be float32 or bfloat16, got {vol.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if vol.device != coords.device:
        raise ValueError(f"vol on {vol.device}, coords on {coords.device}")
    if not isinstance(radius, int) or radius < 1 or (
            2 * radius + 2 > MAX_PATCH):
        raise ValueError(f"radius must be an int with 1 <= r and "
                         f"2r+2 <= {MAX_PATCH}, got {radius!r}")


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from bflow_tpu_torch.kernels import build

        fn = getattr(build.load(NAME), f"{NAME}_{_DTYPES[dtype]}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def corr_lookup_level(vol: torch.Tensor, coords: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """(Q, hl, wl) volume, (Q, 2) coords -> (Q, (2r+1)^2) taps.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    corr_lookup_level_plain. Forward only: the backward kernel is not
    ported yet, so a CUDA call that would need gradients raises."""
    global launches
    _check(vol, coords, radius)
    if vol.device.type == "cpu":
        return corr_lookup_level_plain(vol, coords, radius)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if torch.is_grad_enabled() and (vol.requires_grad
                                    or coords.requires_grad):
        raise NotImplementedError(
            "the lookup backward kernel is not ported yet (ROADMAP "
            "Queue 2 item 2); run the forward under torch.no_grad()")
    if not (vol.is_contiguous() and coords.is_contiguous()):
        raise ValueError("vol and coords must be contiguous")
    win = 2 * radius + 1
    Q, hl, wl = vol.shape
    if hl == 0 or wl == 0:  # a pooled-away level: every tap is padding
        return vol.new_zeros((Q, win * win))
    out = torch.empty((Q, win * win), dtype=vol.dtype, device=vol.device)
    fn = _kernel_fn(vol.dtype)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        err = fn(vol.data_ptr(), coords.data_ptr(), out.data_ptr(), Q,
                 hl, wl, radius, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    launches += 1
    return out
