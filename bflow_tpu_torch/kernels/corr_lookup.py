"""Windowed bilinear correlation lookup, one pyramid level: CUDA kernel
wrappers (forward, backward, int8 forward) and their plain PyTorch
versions, and the int8 quantization of a volume.

Counterpart of the TPU kernels bflow_tpu/ops/pallas/corr_lookup_v3.py:
_fwd_kernel (also with quant=True, lookup_level_slab_q8) and _bwd_kernel
(custom VJP _lookup_cvjp). The CUDA sources are csrc/corr_lookup_fwd.cu,
csrc/corr_lookup_q8.cu and csrc/corr_lookup_bwd.cu (their headers say what
bounds them and how they are laid out). Layout, per level:

  vol     (Q, hl, wl)  each query's own correlation map, f32 or bf16
                       (int8 for the q8 lookup, with one f32 scale per
                       query row of w1 queries)
  coords  (Q, 2)       f32 positions in this level's map pixels, (x, y)
  out     (Q, (2r+1)^2) taps at (x+dx, y+dy), dy-major, in vol's type
                       (bf16 for the q8 lookup)

with Q = Tl * N * h1 * w1, the all-pairs volume's own layout. The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernels (the backward through a torch.autograd.Function) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from bflow_tpu_torch.ops.sampler import bilinear_sample

NAME = "corr_lookup_fwd"
BWD_NAME = "corr_lookup_bwd"
Q8_NAME = "corr_lookup_q8"
MAX_PATCH = 16  # 2r+2 <= 16, the TPU kernel's limit as well

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0
bwd_launches = 0
q8_launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def corr_lookup_level_bwd_plain(vol: torch.Tensor, coords: torch.Tensor,
                                g: torch.Tensor, radius: int):
    """The lookup's VJP as plain PyTorch: (dvol in vol's type, dcoords f32)
    for the cotangent g (Q, (2r+1)^2).

    Autograd runs through corr_lookup_level_plain on vol.float(), so the
    four corners of every tap accumulate in f32 and dvol is rounded once
    to vol's type (torch.gather's own backward on a bf16 volume would
    accumulate in bf16): the exact oracle of the backward kernel."""
    if vol.shape[1] == 0 or vol.shape[2] == 0:  # a pooled-away level
        return torch.zeros_like(vol), torch.zeros_like(coords)
    with torch.enable_grad():
        v = vol.detach().float().requires_grad_(True)
        c = coords.detach().requires_grad_(True)
        out = corr_lookup_level_plain(v, c, radius)
        dv, dc = torch.autograd.grad(out, (v, c), g.float())
    return dv.to(vol.dtype), dc


def _check(vol: torch.Tensor, coords: torch.Tensor, radius: int,
           dtypes=tuple(_DTYPES)) -> None:
    if vol.dim() != 3 or coords.dim() != 2 or coords.shape != (
            vol.shape[0], 2):
        raise ValueError(
            f"want vol (Q, hl, wl) and coords (Q, 2), got "
            f"{tuple(vol.shape)} and {tuple(coords.shape)}")
    if vol.dtype not in dtypes:
        raise TypeError(f"vol must be one of {dtypes}, got {vol.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if vol.device != coords.device:
        raise ValueError(f"vol on {vol.device}, coords on {coords.device}")
    if not isinstance(radius, int) or radius < 1 or (
            2 * radius + 2 > MAX_PATCH):
        raise ValueError(f"radius must be an int with 1 <= r and "
                         f"2r+2 <= {MAX_PATCH}, got {radius!r}")


_ARGTYPES = {
    # vol, coords, out, n_query, hl, wl, radius, stream
    NAME: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
    # vol, coords, g, dvol, dcoords, n_query, hl, wl, radius, stream
    BWD_NAME: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # vol, scale, coords, out, n_query, hl, wl, radius, w1, stream
    Q8_NAME: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args):
    from bflow_tpu_torch.kernels import build

    fn = build.function(name, f"{name}_{_DTYPES[dtype]}", _ARGTYPES[name])
    build.launch(fn, device, *args)


def _lookup_fwd_cuda(vol: torch.Tensor, coords: torch.Tensor,
                     radius: int) -> torch.Tensor:
    global launches
    win = 2 * radius + 1
    Q, hl, wl = vol.shape
    if hl == 0 or wl == 0:  # a pooled-away level: every tap is padding
        return vol.new_zeros((Q, win * win))
    out = torch.empty((Q, win * win), dtype=vol.dtype, device=vol.device)
    _launch(NAME, vol.dtype, vol.device, vol.data_ptr(), coords.data_ptr(),
            out.data_ptr(), Q, hl, wl, radius)
    launches += 1
    return out


def lookup_bwd_into(vol: torch.Tensor, coords: torch.Tensor,
                    g: torch.Tensor, radius: int, dvol, dcoords) -> None:
    """Launch the backward kernel into dvol (zeroed, vol's shape and
    type; only each query's in-map patch is written) and dcoords ((Q, 2)
    f32); either may be None. Contiguous CUDA tensors."""
    global bwd_launches
    Q, hl, wl = vol.shape
    if hl == 0 or wl == 0 or (dvol is None and dcoords is None):
        return  # a pooled-away level has zero gradients
    _launch(BWD_NAME, vol.dtype, vol.device, vol.data_ptr(),
            coords.data_ptr(), g.data_ptr(),
            None if dvol is None else dvol.data_ptr(),
            None if dcoords is None else dcoords.data_ptr(),
            Q, hl, wl, radius)
    bwd_launches += 1


def lookup_bwd_cuda(vol: torch.Tensor, coords: torch.Tensor,
                    g: torch.Tensor, radius: int, need_vol: bool = True,
                    need_coords: bool = True):
    """(dvol or None, dcoords or None) through the backward kernel."""
    Q = vol.shape[0]
    win = 2 * radius + 1
    if g.shape != (Q, win * win):
        raise ValueError(f"cotangent {tuple(g.shape)}, want {(Q, win * win)}")
    # the cotangent of the fused convc1 or of the concat path's
    # permute/cat arrives strided
    g = g.to(vol.dtype).contiguous()
    dvol = torch.zeros_like(vol) if need_vol else None
    dcoords = torch.zeros_like(coords) if need_coords else None
    lookup_bwd_into(vol, coords, g, radius, dvol, dcoords)
    return dvol, dcoords


class _LookupFn(torch.autograd.Function):
    """The CUDA lookup with the CUDA backward as its VJP."""

    @staticmethod
    def forward(ctx, vol, coords, radius):
        ctx.radius = radius
        ctx.save_for_backward(vol, coords)
        return _lookup_fwd_cuda(vol, coords, radius)

    @staticmethod
    def backward(ctx, g):
        vol, coords = ctx.saved_tensors
        need_vol, need_coords = ctx.needs_input_grad[:2]
        dvol, dcoords = lookup_bwd_cuda(vol, coords, g, ctx.radius,
                                        need_vol, need_coords)
        return dvol, dcoords, None


def corr_lookup_level(vol: torch.Tensor, coords: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """(Q, hl, wl) volume, (Q, 2) coords -> (Q, (2r+1)^2) taps.

    CUDA tensors go through the hand-written kernels (forward, and the
    backward kernel under autograd), CPU tensors through
    corr_lookup_level_plain, whose gradient is torch's own."""
    _check(vol, coords, radius)
    if vol.device.type == "cpu":
        return corr_lookup_level_plain(vol, coords, radius)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if not (vol.is_contiguous() and coords.is_contiguous()):
        raise ValueError("vol and coords must be contiguous")
    return _LookupFn.apply(vol, coords, radius)


# ---------------------------------------------------------------------------
# int8 volumes (lookup_method="pallas_q8"): inference only


def quantize_volume(vol: torch.Tensor):
    """(Tl, N, h1, w1, hl, wl) volume -> (int8 volume, (Tl, N, h1) f32
    scale), symmetric with one scale per query row: the JAX package's
    _quantize over (w1, hl, wl). The amax and the scale are f32; the
    elementwise pass stays in the volume's type (the product rounded to
    it, then rounded half to even and clipped to +-127)."""
    amax = vol.abs().amax(dim=(3, 4, 5)).float()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    inv = (1.0 / scale).to(vol.dtype)[..., None, None, None]
    q = torch.round(vol * inv).clamp_(-127, 127).to(torch.int8)
    return q, scale


def corr_lookup_level_q8_plain(vol: torch.Tensor, scale: torch.Tensor,
                               coords: torch.Tensor,
                               radius: int) -> torch.Tensor:
    """The int8 lookup as a torch gather: the integers blended in f32,
    times the query row's f32 scale, rounded once to bf16."""
    rows = scale.reshape(-1)
    per_query = rows.repeat_interleave(vol.shape[0] // rows.numel())
    pts = coords[:, None, :] + window_offsets(radius, coords.device,
                                              coords.dtype)
    out = bilinear_sample(vol.float(), pts) * per_query[:, None]
    return out.to(torch.bfloat16)


def _check_q8(vol: torch.Tensor, scale: torch.Tensor, coords: torch.Tensor,
              radius: int) -> None:
    _check(vol, coords, radius, (torch.int8,))
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if scale.device != vol.device:
        raise ValueError(f"vol on {vol.device}, scale on {scale.device}")
    if scale.numel() == 0 or vol.shape[0] % scale.numel():
        raise ValueError(f"{scale.numel()} scale rows for {vol.shape[0]} "
                         f"queries")
    if vol.shape[1] == 0 or vol.shape[2] == 0:
        raise ValueError(f"empty map {tuple(vol.shape)}: levels that small "
                         f"stay unquantized")


def corr_lookup_level_q8(vol: torch.Tensor, scale: torch.Tensor,
                         coords: torch.Tensor, radius: int) -> torch.Tensor:
    """(Q, hl, wl) int8 volume, per-row scale (Q / w1 values, e.g. the
    (Tl, N, h1) scale of quantize_volume), (Q, 2) coords -> (Q, (2r+1)^2)
    bf16 taps. Forward only, as the JAX package's lookup_level_slab_q8:
    under autograd it raises. CUDA tensors go through the kernel, CPU
    tensors through corr_lookup_level_q8_plain."""
    global q8_launches
    _check_q8(vol, scale, coords, radius)
    if torch.is_grad_enabled() and (coords.requires_grad
                                    or scale.requires_grad):
        raise RuntimeError(
            "the int8 lookup (lookup_method='pallas_q8') is inference "
            "only: it has no gradient. Run it under torch.no_grad() or "
            "test_mode=True, or train with lookup_method='pallas'")
    if vol.device.type == "cpu":
        return corr_lookup_level_q8_plain(vol, scale, coords, radius)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if not (vol.is_contiguous() and scale.is_contiguous()
            and coords.is_contiguous()):
        raise ValueError("vol, scale and coords must be contiguous")
    Q, hl, wl = vol.shape
    win = 2 * radius + 1
    out = torch.empty((Q, win * win), dtype=torch.bfloat16,
                      device=vol.device)
    _launch(Q8_NAME, torch.bfloat16, vol.device, vol.data_ptr(),
            scale.data_ptr(), coords.data_ptr(), out.data_ptr(), Q, hl, wl,
            radius, Q // scale.numel())
    q8_launches += 1
    return out
