"""Windowed bilinear correlation lookup: CUDA kernel wrappers (the
all-level forward, also over int8 levels, and backward) and their plain
PyTorch versions, the autograd plumbing that accumulates dVol, and the
int8 quantization of a volume.

Counterpart of the TPU kernels bflow_tpu/ops/pallas/corr_lookup_v3.py:
_fwd_kernel (also with quant=True, lookup_level_slab_q8) and _bwd_kernel
(custom VJP _lookup_cvjp). The CUDA sources are csrc/corr_lookup_fwd.cu
and csrc/corr_lookup_bwd.cu, both over the level table of
csrc/corr_lookup_table.cuh; their headers say what bounds them and how
they work. One forward launch looks up every level of a level table:

  table   per level: its volume (Tl, N, h1, w1, hl, wl), f32 or bf16, one
          (hl, wl) map per query (zero-size maps: a pooled-away level),
          or int8 with its (Tl, N, h1) f32 row scales (quantize_volume);
          its base-target indices; its pyramid index l (coords / 2^l)
  coords  (T, N, h1, w1, 2) f32 base coords, (x, y), in level-0 pixels
  out     (N, h1, w1, C) in the unquantized levels' type (they share
          one; bf16 for int8 levels only: the type torch.cat gives the
          per-level lookups), C = 81 x the table's targets, channels
          (level, target, dy-major window): the concat=True contract of
          models.corr.corr_lookup and the matrix the fused convc1 reads

The backward launch reads the cotangent of `out` (rows of C channels at
any row stride), adds every query's patch contribution to one f32 dVol
accumulator per level, and writes dcoords for the base coords. The
accumulators belong to a VolumeSink, one per pyramid: its autograd node
passes the volumes through as a zero-size token that every lookup takes
as its differentiable input, so it runs after all of them and hands the
summed buffers to the volumes' producer once per backward pass.

A table with an int8 level has no backward (inference only, as the JAX
package's lookup_level_slab_q8): under autograd it raises.

The one-level entries (corr_lookup_level, lookup_bwd_cuda,
corr_lookup_level_q8) are the same kernels and the same autograd
structure with a one-level table and (Q, hl, wl) volumes, (Q, 2) coords
at the level's scale, (Q, 81) taps.

The wrappers take the plain versions only for tensors on the CPU, through
the same autograd structure; for CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from bflow_tpu_torch.ops.sampler import bilinear_sample

NAME = "corr_lookup_fwd"
BWD_NAME = "corr_lookup_bwd"
MAX_PATCH = 16  # 2r+2 <= 16, the TPU kernel's limit as well
# csrc/corr_lookup_table.cuh
MAX_LEVELS = 8
MAX_SLOTS = 32
MAX_TARGETS = 255

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# csrc/corr_lookup_table.cuh: LevelType
_LEVEL_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q8_INFERENCE_ONLY = (
    "the int8 lookup (lookup_method='pallas_q8') is inference only: it "
    "has no gradient. Run it under torch.no_grad() or test_mode=True, or "
    "train with lookup_method='pallas'")


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


# ---------------------------------------------------------------------------
# the level table and its plain versions


class TableLevel(NamedTuple):
    """One row of the level table: a pyramid level's volume
    (Tl, N, h1, w1, hl, wl), its base-target indices (Tl of them), its
    pyramid index, which scales the base coords by 2^-level, and for an
    int8 volume its (Tl, N, h1) f32 scale per query row (quantize_volume;
    None for f32 and bf16 volumes)."""
    vol: torch.Tensor
    targets: Tuple[int, ...]
    level: int
    scale: Optional[torch.Tensor] = None


def _out_dtype(table: Sequence[TableLevel]) -> torch.dtype:
    """The all-level lookup's output type: the unquantized levels' type,
    bf16 for a table of int8 levels only (an int8 level's taps are bf16):
    the type torch.cat gives the per-level lookups."""
    return next((lv.vol.dtype for lv in table if lv.vol.dtype != torch.int8),
                torch.bfloat16)


def _level_coords(coords: torch.Tensor, lv: TableLevel) -> torch.Tensor:
    """(Q, 2) coords of a level's queries: the composition the JAX package
    runs, coords[idx] / 2^l (exact: a power-of-two scale)."""
    return (coords[list(lv.targets)] / (2.0 ** lv.level)).reshape(-1, 2)


def _level_maps(lv: TableLevel) -> torch.Tensor:
    """(Q, hl, wl) maps of a level (Q stated: a pooled-away level's maps
    are empty)."""
    q = lv.vol.shape[:4].numel()
    return lv.vol.reshape(q, *lv.vol.shape[-2:])


def corr_lookup_pyramid_plain(table: Sequence[TableLevel],
                              coords: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """The all-level lookup as plain PyTorch: per level the index and
    divide of the base coords, the gather lookup (int8 levels:
    corr_lookup_level_q8_plain), and the (level, target, window) channel
    order -> (N, h1, w1, C) in the output type (_out_dtype)."""
    _, N, h1, w1, _ = coords.shape
    dtype = _out_dtype(table)
    parts = []
    for lv in table:
        if lv.vol.dtype == torch.int8:
            feat = corr_lookup_level_q8_plain(
                _level_maps(lv), lv.scale, _level_coords(coords, lv), radius)
        else:
            feat = corr_lookup_level_plain(_level_maps(lv),
                                           _level_coords(coords, lv), radius)
        parts.append(feat.reshape(len(lv.targets), N, h1, w1, -1)
                     .permute(1, 2, 3, 0, 4).reshape(N, h1, w1, -1)
                     .to(dtype))
    return torch.cat(parts, dim=-1)


def corr_lookup_pyramid_bwd_plain(table: Sequence[TableLevel],
                                  coords: torch.Tensor, g: torch.Tensor,
                                  radius: int,
                                  dvols: Optional[List[torch.Tensor]],
                                  need_coords: bool = True):
    """The all-level lookup's VJP as plain PyTorch, for the cotangent g
    (N, h1, w1, C) of corr_lookup_pyramid_plain's output.

    Per level, corr_lookup_level_bwd_plain (autograd through the f32
    gather): its dvol, rounded once to the volume's type, is added in f32
    to dvols[i] (an f32 buffer of level i's volume shape; dvols may be
    None). Returns dcoords for the base coords (T, N, h1, w1, 2) f32, each
    target's level contributions scaled by 2^-l and summed in level order
    from zero, or None without need_coords. An int8 level raises: it has
    no backward."""
    _refuse_int8_backward(table)
    _, N, h1, w1, _ = coords.shape
    win2 = (2 * radius + 1) ** 2
    dcoords = torch.zeros_like(coords) if need_coords else None
    off = 0
    for i, lv in enumerate(table):
        tl = len(lv.targets)
        gl = g[..., off:off + tl * win2].reshape(N, h1, w1, tl, win2)
        off += tl * win2
        dv, dc = corr_lookup_level_bwd_plain(
            _level_maps(lv), _level_coords(coords, lv),
            gl.permute(3, 0, 1, 2, 4).reshape(-1, win2), radius)
        if dvols is not None:
            dvols[i] += dv.reshape(lv.vol.shape).float()
        if need_coords:
            idx = list(lv.targets)
            dcoords[idx] = dcoords[idx] + (
                dc.reshape(tl, N, h1, w1, 2) / (2.0 ** lv.level))
    return dcoords


# ---------------------------------------------------------------------------
# the CUDA kernels


def _refuse_int8_backward(table: Sequence[TableLevel]) -> None:
    if any(lv.vol.dtype == torch.int8 for lv in table):
        raise ValueError("a table with an int8 level has no backward: "
                         + _Q8_INFERENCE_ONLY)


class _LevelDesc(ctypes.Structure):
    """csrc/corr_lookup_table.cuh: LevelDesc."""
    _fields_ = [("vol", ctypes.c_void_p), ("dvol", ctypes.c_void_p),
                ("row_scale", ctypes.c_void_p),
                ("hl", ctypes.c_int), ("wl", ctypes.c_int),
                ("n_targets", ctypes.c_int), ("scale", ctypes.c_float),
                ("type", ctypes.c_int), ("pad", ctypes.c_int)]


class _LookupTable(ctypes.Structure):
    """csrc/corr_lookup_table.cuh: LookupTable."""
    _fields_ = [("level", _LevelDesc * MAX_LEVELS),
                ("slot_level", ctypes.c_ubyte * MAX_SLOTS),
                ("slot_k", ctypes.c_ubyte * MAX_SLOTS),
                ("slot_target", ctypes.c_ubyte * MAX_SLOTS),
                ("n_slots", ctypes.c_int), ("n_targets", ctypes.c_int),
                ("radius", ctypes.c_int), ("w1", ctypes.c_int),
                ("queries", ctypes.c_longlong), ("ld", ctypes.c_longlong)]


def _check_radius(radius: int) -> None:
    if not isinstance(radius, int) or radius < 1 or (
            2 * radius + 2 > MAX_PATCH):
        raise ValueError(f"radius must be an int with 1 <= r and "
                         f"2r+2 <= {MAX_PATCH}, got {radius!r}")


def _check_table(table: Sequence[TableLevel], coords: torch.Tensor,
                 radius: int) -> None:
    """What the kernels take: checked before any pointer is handed over."""
    _check_radius(radius)
    if coords.dim() != 5 or coords.shape[-1] != 2:
        raise ValueError(f"want coords (T, N, h1, w1, 2), got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    T, N, h1, w1, _ = coords.shape
    if not table:
        raise ValueError("empty level table")
    if len(table) > MAX_LEVELS or T > MAX_TARGETS or sum(
            len(lv.targets) for lv in table) > MAX_SLOTS:
        raise ValueError(f"{len(table)} levels, {T} targets: the kernels "
                         f"take <= {MAX_LEVELS} levels, <= {MAX_TARGETS} "
                         f"targets and <= {MAX_SLOTS} (level, target) pairs")
    dtype = _out_dtype(table)
    for lv in table:
        v = lv.vol
        if v.dim() != 6 or tuple(v.shape[:4]) != (len(lv.targets), N, h1,
                                                  w1):
            raise ValueError(f"level {lv.level}: volume {tuple(v.shape)} "
                             f"for {len(lv.targets)} targets and queries "
                             f"{(N, h1, w1)}")
        if v.dtype == torch.int8:
            _check_row_scale(lv, coords)
        elif v.dtype != dtype or dtype not in _DTYPES:
            raise TypeError(f"unquantized volumes must share one of "
                            f"{tuple(_DTYPES)}, got {v.dtype} and {dtype}")
        elif lv.scale is not None:
            raise ValueError(f"level {lv.level}: a row scale belongs to an "
                             f"int8 volume, not {v.dtype}")
        if v.device != coords.device:
            raise ValueError(f"volume on {v.device}, coords on "
                             f"{coords.device}")
        if not all(0 <= t < T for t in lv.targets) or len(
                set(lv.targets)) != len(lv.targets):
            raise ValueError(f"level {lv.level}: targets {lv.targets} of "
                             f"{T}")
        if not 0 <= lv.level < 64:
            raise ValueError(f"level index {lv.level}")


def _check_row_scale(lv: TableLevel, coords: torch.Tensor) -> None:
    """An int8 level's scale: (Tl, N, h1) f32, contiguous, beside the
    coords; and a map to look up (levels that small stay unquantized)."""
    Tl, N, h1 = lv.vol.shape[:3]
    s = lv.scale
    if s is None:
        raise ValueError(f"level {lv.level}: an int8 volume needs its row "
                         f"scale (quantize_volume)")
    if s.dtype != torch.float32:
        raise TypeError(f"level {lv.level}: row scale must be float32, got "
                        f"{s.dtype}")
    if tuple(s.shape) != (Tl, N, h1) or not s.is_contiguous():
        raise ValueError(f"level {lv.level}: row scale {tuple(s.shape)}, "
                         f"want contiguous {(Tl, N, h1)}")
    if s.device != coords.device:
        raise ValueError(f"row scale on {s.device}, coords on "
                         f"{coords.device}")
    if lv.vol.shape[4] == 0 or lv.vol.shape[5] == 0:
        raise ValueError(f"level {lv.level}: empty int8 map "
                         f"{tuple(lv.vol.shape)}: levels that small stay "
                         f"unquantized")


def _table_struct(table: Sequence[TableLevel], coords: torch.Tensor,
                  radius: int, ld: int, dvols=None) -> _LookupTable:
    tab = _LookupTable()
    s = 0
    for i, lv in enumerate(table):
        d = tab.level[i]
        d.vol = lv.vol.data_ptr()
        d.dvol = None if dvols is None else dvols[i].data_ptr()
        d.row_scale = None if lv.scale is None else lv.scale.data_ptr()
        d.type = _LEVEL_TYPES[lv.vol.dtype]
        d.hl, d.wl = lv.vol.shape[-2:]
        d.n_targets = len(lv.targets)
        d.scale = 2.0 ** -lv.level  # exact in f32 for level < 64
        for k, t in enumerate(lv.targets):
            tab.slot_level[s], tab.slot_k[s], tab.slot_target[s] = i, k, t
            s += 1
    tab.n_slots = s
    tab.n_targets = coords.shape[0]
    tab.radius = radius
    tab.w1 = coords.shape[3]
    tab.queries = coords.shape[1] * coords.shape[2] * coords.shape[3]
    tab.ld = ld
    return tab


_ARGTYPES = {
    # table*, coords, out, stream
    NAME: [ctypes.POINTER(_LookupTable), ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p],
    # table* (dvol accumulators inside), coords, g, dcoords, stream
    BWD_NAME: [ctypes.POINTER(_LookupTable), ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args):
    from bflow_tpu_torch.kernels import build

    fn = build.function(name, f"{name}_{_DTYPES[dtype]}", _ARGTYPES[name])
    build.launch(fn, device, *args)


def _rows(g: torch.Tensor, C: int):
    """g (N, h1, w1, C) as rows of C channels: (tensor, row stride). A
    slice of a wider cotangent (the cat of kernel and non-kernel levels)
    is read in place; any other layout is copied once."""
    M = g.numel() // C
    try:
        rows = g.view(M, C)
    except RuntimeError:
        rows = None
    if rows is None or (C > 1 and rows.stride(1) != 1):
        g = g.contiguous()
        return g, C
    return g, (rows.stride(0) if M > 1 else C)


def lookup_pyramid_cuda(table: Sequence[TableLevel], coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """One launch of the forward kernel over every level of the table ->
    (N, h1, w1, C), the layout and type of corr_lookup_pyramid_plain."""
    global launches
    _check_table(table, coords, radius)
    if not all(lv.vol.is_contiguous() for lv in table):
        raise ValueError("volumes must be contiguous")
    coords = coords.contiguous()
    _, N, h1, w1, _ = coords.shape
    C = sum(len(lv.targets) for lv in table) * (2 * radius + 1) ** 2
    dtype = _out_dtype(table)
    out = torch.empty((N, h1, w1, C), dtype=dtype, device=coords.device)
    tab = _table_struct(table, coords, radius, C)
    _launch(NAME, dtype, coords.device, ctypes.byref(tab),
            coords.data_ptr(), out.data_ptr())
    launches += 1
    return out


def lookup_pyramid_bwd_cuda(table: Sequence[TableLevel],
                            coords: torch.Tensor, g: torch.Tensor,
                            radius: int,
                            dvols: Optional[List[torch.Tensor]],
                            need_coords: bool = True):
    """One launch of the backward kernel over every level of the table:
    adds each level's dvol (rounded to the volume's type per query cell)
    into the f32 accumulators dvols (or none), and returns dcoords for the
    base coords (T, N, h1, w1, 2) f32 (or None). A table with an int8
    level raises before any launch."""
    global bwd_launches
    _refuse_int8_backward(table)
    _check_table(table, coords, radius)
    if not all(lv.vol.is_contiguous() for lv in table):
        raise ValueError("volumes must be contiguous")
    _, N, h1, w1, _ = coords.shape
    C = sum(len(lv.targets) for lv in table) * (2 * radius + 1) ** 2
    if tuple(g.shape) != (N, h1, w1, C):
        raise ValueError(f"cotangent {tuple(g.shape)}, want "
                         f"{(N, h1, w1, C)}")
    if dvols is not None and not all(
            b.dtype == torch.float32 and b.is_contiguous()
            and b.shape == lv.vol.shape and b.device == coords.device
            for b, lv in zip(dvols, table)):
        raise ValueError("dvol accumulators must be contiguous f32 "
                         "tensors of the volumes' shapes")
    if dvols is None and not need_coords:
        return None
    coords = coords.contiguous()
    dtype = table[0].vol.dtype
    g, ld = _rows(g.to(dtype), C)
    dcoords = torch.empty_like(coords) if need_coords else None
    tab = _table_struct(table, coords, radius, ld, dvols)
    _launch(BWD_NAME, dtype, coords.device, ctypes.byref(tab),
            coords.data_ptr(), g.data_ptr(),
            None if dcoords is None else dcoords.data_ptr())
    bwd_launches += 1
    return dcoords


def _pyramid_fwd(table, coords, radius):
    if coords.device.type == "cpu":
        return corr_lookup_pyramid_plain(table, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    return lookup_pyramid_cuda(table, coords, radius)


def _pyramid_bwd(table, coords, g, radius, dvols, need_coords):
    if coords.device.type == "cpu":
        return corr_lookup_pyramid_bwd_plain(table, coords, g, radius,
                                             dvols, need_coords)
    return lookup_pyramid_bwd_cuda(table, coords, g, radius, dvols,
                                   need_coords)


# ---------------------------------------------------------------------------
# autograd: one dVol accumulator per level for a whole backward pass


class _Accumulators:
    """The f32 dVol buffers of one backward pass, per volume of a table."""

    def __init__(self, vols: Sequence[torch.Tensor]):
        self.vols = [v.detach() for v in vols]
        self._task = None
        self._bufs: Optional[List[torch.Tensor]] = None

    def buffers(self, node) -> Optional[List[torch.Tensor]]:
        """The running backward pass's buffers, allocated zeroed on first
        use, or None when that pass does not run the sink's node."""
        if node is None or not torch._C._will_engine_execute_node(node):
            return None
        task = torch._C._current_graph_task_id()
        if self._bufs is None or self._task != task:  # a new pass
            self._bufs = [torch.zeros(v.shape, dtype=torch.float32,
                                      device=v.device) for v in self.vols]
            self._task = task
        return self._bufs

    def take(self):
        bufs, self._bufs, self._task = self._bufs, None, None
        if bufs is None:
            return tuple(None for _ in self.vols)
        return tuple(b if v.dtype == torch.float32 else b.to(v.dtype)
                     for b, v in zip(bufs, self.vols))


class _SinkFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, *vols):
        ctx.acc = acc
        return vols[0].new_empty(0)

    @staticmethod
    def backward(ctx, _token_grad):
        return (None, *ctx.acc.take())


class VolumeSink:
    """The dVol accumulators of one pyramid's kernel-routed volumes.

    token() passes the volumes through an autograd node as a zero-size
    token, once; every lookup of the pyramid takes the token as its
    differentiable input. In a backward pass the lookups add into one f32
    buffer per volume, allocated zeroed by the first of them; the sink's
    node runs after all of them (it consumes their token gradients) and
    returns the buffers, rounded to each volume's type, as the volumes'
    gradients, once. A pass that does not reach the volumes (a
    torch.autograd.grad for the coords only) allocates nothing. No
    reference leads from the node back to the sink, so a pyramid and its
    graph are freed together."""

    def __init__(self):
        self._acc: Optional[_Accumulators] = None
        self._token: Optional[torch.Tensor] = None
        self._key = None

    def token(self, vols: Sequence[torch.Tensor]):
        """(token, accumulators) for lookups of these volumes, which must
        be the volumes of the sink's first call."""
        key = [(v.data_ptr(), tuple(v.shape)) for v in vols]
        if self._token is None:
            self._acc = _Accumulators(vols)
            self._token = _SinkFn.apply(self._acc, *vols)
            self._key = key
        elif key != self._key:
            raise ValueError(
                "this VolumeSink serves other volumes: one sink per pyramid, "
                "every lookup with the same kernel-routed levels")
        return self._token, self._acc


class _PyramidLookupFn(torch.autograd.Function):
    """The all-level lookup; its backward is the accumulating VJP."""

    @staticmethod
    def forward(ctx, token, coords, acc, table, radius):
        ctx.acc, ctx.table, ctx.radius = acc, table, radius
        ctx.node = token.grad_fn  # the sink's node, or None
        ctx.save_for_backward(coords)
        return _pyramid_fwd(table, coords, radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        dvols = None if ctx.acc is None else ctx.acc.buffers(ctx.node)
        dcoords = _pyramid_bwd(ctx.table, coords, g, ctx.radius, dvols,
                               ctx.needs_input_grad[1])
        return None, dcoords, None, None, None


def corr_lookup_pyramid(table: Sequence[TableLevel], coords: torch.Tensor,
                        radius: int,
                        sink: Optional[VolumeSink] = None) -> torch.Tensor:
    """The all-level lookup (N, h1, w1, C) of the module docstring: one
    kernel launch for CUDA tensors, corr_lookup_pyramid_plain for CPU
    tensors. When the volumes need gradients, dVol goes through ``sink``,
    which is then required: one per pyramid, serving the table's volumes
    in table order, so that every iteration's lookups share its
    accumulators. A table with an int8 level is inference only: under
    autograd it raises."""
    table = tuple(table)
    _check_table(table, coords, radius)
    vol_grad = any(lv.vol.requires_grad for lv in table)
    needs_grad = torch.is_grad_enabled() and (
        vol_grad or coords.requires_grad
        or any(lv.scale is not None and lv.scale.requires_grad
               for lv in table))
    if needs_grad and any(lv.vol.dtype == torch.int8 for lv in table):
        raise RuntimeError(_Q8_INFERENCE_ONLY)
    if not needs_grad:
        return _pyramid_fwd(table, coords.detach(), radius)
    token, acc = coords.new_empty(0), None
    if vol_grad:
        if sink is None:
            raise ValueError(
                "volumes that need gradients take the pyramid's VolumeSink "
                "(models.corr.CorrPyramid carries one)")
        token, acc = sink.token([lv.vol for lv in table])
    plain = tuple(lv._replace(vol=lv.vol.detach()) for lv in table)
    return _PyramidLookupFn.apply(token, coords, acc, plain, radius)


# ---------------------------------------------------------------------------
# one level: (Q, hl, wl) volume, (Q, 2) coords at the level's scale


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
    _check_radius(radius)


def _one_level(vol: torch.Tensor, coords: torch.Tensor):
    """A one-level table over one target with Q queries, and its coords."""
    Q, hl, wl = vol.shape
    return ((TableLevel(vol.reshape(1, 1, 1, Q, hl, wl), (0,), 0),),
            coords.reshape(1, 1, 1, Q, 2))


def lookup_bwd_cuda(vol: torch.Tensor, coords: torch.Tensor,
                    g: torch.Tensor, radius: int, need_vol: bool = True,
                    need_coords: bool = True):
    """(dvol or None, dcoords (Q, 2) f32 or None) of one level through one
    backward launch (CUDA tensors): dvol zeroed, then filled, in vol's
    type."""
    Q = vol.shape[0]
    win = 2 * radius + 1
    if g.shape != (Q, win * win):
        raise ValueError(f"cotangent {tuple(g.shape)}, want {(Q, win * win)}")
    table, c = _one_level(vol, coords)
    acc = (torch.zeros(table[0].vol.shape, dtype=torch.float32,
                       device=vol.device) if need_vol else None)
    dc = lookup_pyramid_bwd_cuda(table, c, g.reshape(1, 1, Q, -1), radius,
                                 None if acc is None else [acc], need_coords)
    dvol = None if acc is None else acc.reshape(vol.shape).to(vol.dtype)
    return dvol, None if dc is None else dc.reshape(Q, 2)


def corr_lookup_level(vol: torch.Tensor, coords: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """(Q, hl, wl) volume, (Q, 2) coords -> (Q, (2r+1)^2) taps: the
    one-level entry.

    CUDA tensors go through corr_lookup_pyramid with a one-level table
    (the forward kernel, and under autograd the backward kernel with a
    sink of its own), CPU tensors through corr_lookup_level_plain, whose
    gradient is torch's own."""
    _check(vol, coords, radius)
    if vol.device.type == "cpu":
        return corr_lookup_level_plain(vol, coords, radius)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if not (vol.is_contiguous() and coords.is_contiguous()):
        raise ValueError("vol and coords must be contiguous")
    table, c = _one_level(vol, coords)
    return corr_lookup_pyramid(table, c, radius,
                               VolumeSink()).reshape(vol.shape[0], -1)


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
    under autograd it raises. CUDA tensors go through the forward kernel
    with a one-level int8 table, CPU tensors through
    corr_lookup_level_q8_plain."""
    _check_q8(vol, scale, coords, radius)
    if torch.is_grad_enabled() and (coords.requires_grad
                                    or scale.requires_grad):
        raise RuntimeError(_Q8_INFERENCE_ONLY)
    if vol.device.type == "cpu":
        return corr_lookup_level_q8_plain(vol, scale, coords, radius)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if not (vol.is_contiguous() and scale.is_contiguous()
            and coords.is_contiguous()):
        raise ValueError("vol, scale and coords must be contiguous")
    # one target, one image, rows of Q / rows queries: one scale a row
    Q, hl, wl = vol.shape
    rows = scale.numel()
    table = (TableLevel(vol.reshape(1, 1, rows, Q // rows, hl, wl), (0,), 0,
                        scale.reshape(1, 1, rows)),)
    out = lookup_pyramid_cuda(table, coords.reshape(1, 1, rows, Q // rows, 2),
                              radius)
    return out.reshape(Q, -1)
