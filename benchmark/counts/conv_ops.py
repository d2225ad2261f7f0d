"""What the two hand-written conv kernels must do in one request: their
launches, and each launch's operations, bytes and bound time.

The convs are the reference's own (``Reference.conv``), seen by a
subclass as the reference runs on the meta device (no memory, no
device), as ``counts/flops.py`` counts there. Which of them a kernel
takes is decided as the program decides it, from the configuration's
switches and the gates of the JAX package, copied below
(bflow_tpu/ops/pallas/conv3x3.py:supported, stem_conv.py:supported) so
that no change to the program moves the count:

- the 7x7/s2 stems go to the stem kernel under ``pallas_stem``;
- every other conv with a window wider than 1x1 goes under
  ``pallas_conv``: stride 1 to the conv3x3 kernel, stride 2 to the stem
  kernel;
- each only in the bf16 fast mode and where its gate passes on the
  input's NHWC shape; 1x1 convs never.

The program runs the GRU in the JAX package's fused form, so a pass's
three gate convs are counted as the two it launches: one over [h, x] to
3 x hidden channels ([z | r | q_x], where the reference's ``convz``
runs) and one over r*h, hidden to hidden (where its ``convq`` runs); its
``convr`` launches nothing of its own. Each is gated on its own shape.

Per launch, for an (N, C, H, W) input, O outputs, a kh x kw window and
stride s (Ho = (H - 1) // s + 1, likewise Wo):
  operations  2 N Ho Wo O C kh kw
  bytes       the input read once with its channels padded to a multiple
              of 8, Cp (bf16), the (O, kh, kw, Cp) bf16 weights, the f32
              bias and the bf16 output, each once
  bound       max(operations / the bf16 peak, bytes / the HBM peak), s
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.counts.peaks import FLOPS, HBM_BYTES_PER_S
from benchmark.reference.model import Reference

CONV3X3 = "conv3x3"
STEM = "stem_conv"
STRIDE = {CONV3X3: 1, STEM: 2}  # the kernels' template argument S

# -- the JAX package's gates (the bf16 compute type is checked by the caller)

_P_BYTES = 2_000_000  # conv3x3: the TPU kernel's patch scratch budget
_VMEM_BYTES = 8_000_000  # conv3x3: its whole working-set budget
_K_MAX = 2048  # stem: the contraction-depth cap


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _conv3x3_ri(h: int, kh: int) -> int:
    for cand in (16, 12, 10, 8, 6, 5, 4, 3, 2):
        if h % cand == 0 and cand >= kh - 1:
            return cand
    return 0


def conv3x3_supported(nhwc: Tuple[int, int, int, int], out_features: int,
                      kh: int, kw: int) -> bool:
    _, h, w, c = nhwc
    w = _round_up(w, 8)
    ri = _conv3x3_ri(h, kh)
    if ri == 0 or out_features < 32:
        return False
    k = kh * kw * c
    vmem = (4 * ri * (w + kw - 1) * c * 2 + min(_P_BYTES, ri * w * k * 2)
            + k * out_features * 2 + 2 * ri * w * out_features * 2)
    return vmem < _VMEM_BYTES


def _taps(k: int) -> int:
    return (k + 1) // 2


def _stem_ri(hs: int, ta: int) -> int:
    for cand in (16, 12, 10, 8, 6, 5, 4, 3):
        if hs % cand == 0 and cand >= ta - 1:
            return cand
    return 0


def stem_supported(nhwc: Tuple[int, int, int, int], kh: int,
                   kw: int) -> bool:
    _, h, w, c = nhwc
    if kh % 2 == 0 or kw % 2 == 0 or (kh // 2) % 2 == 0:
        return False
    ta, tb = _taps(kh), _taps(kw)
    k = ta * tb * 4 * _round_up(c, 16)
    return (h % 2 == 0 and w % 2 == 0 and k <= _K_MAX
            and _stem_ri(h // 2, ta) > 0)


# -- the launches


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of ``kernel`` on an (n, c, h, w) input: o outputs, a
    kh x kw window, ``stride``; ``what`` names the reference's conv."""

    kernel: str
    what: str
    n: int
    c: int
    h: int
    w: int
    o: int
    kh: int
    kw: int
    stride: int

    @property
    def out_hw(self) -> Tuple[int, int]:
        s = self.stride
        return (self.h - 1) // s + 1, (self.w - 1) // s + 1

    @property
    def operations(self) -> int:
        ho, wo = self.out_hw
        return 2 * self.n * ho * wo * self.o * self.c * self.kh * self.kw

    @property
    def bytes(self) -> int:
        ho, wo = self.out_hw
        cp = _round_up(self.c, 8)
        return (self.n * self.h * self.w * cp * 2
                + self.o * self.kh * self.kw * cp * 2 + self.o * 4
                + self.n * ho * wo * self.o * 2)

    @property
    def bound_s(self) -> float:
        return max(self.operations / FLOPS["bfloat16"],
                   self.bytes / HBM_BYTES_PER_S)


def kernel_for(model_cfg: Dict, precision: str, n: int, c: int, h: int,
               w: int, o: int, kh: int, kw: int,
               stride: int) -> Optional[str]:
    """The kernel the program sends this conv to, or None (it stays on
    F.conv2d)."""
    if precision != "bfloat16" or kh * kw == 1:
        return None
    nhwc = (n, h, w, c)
    if stride == 2:
        switch = "pallas_stem" if (kh, kw) == (7, 7) else "pallas_conv"
        if model_cfg.get(switch) and stem_supported(nhwc, kh, kw):
            return STEM
    elif stride == 1 and model_cfg.get("pallas_conv"):
        if conv3x3_supported(nhwc, o, kh, kw):
            return CONV3X3
    return None


class _Counting(Reference):
    """The reference, noting the kernel launches its convs stand for."""

    def __init__(self, model_cfg: Dict, params: Dict[str, torch.Tensor],
                 precision: str):
        super().__init__(model_cfg, params)
        self.precision = precision
        self.launches: List[Launch] = []

    def _note(self, what, n, c, h, w, o, kh, kw, stride):
        kernel = kernel_for(self.c, self.precision, n, c, h, w, o, kh, kw,
                            stride)
        if kernel is not None:
            self.launches.append(Launch(kernel, what, n, c, h, w, o, kh, kw,
                                        stride))

    def conv(self, name: str, x, stride: int = 1, padding=0):
        n, c, h, w = x.shape
        o, _, kh, kw = self.p[name + ".weight"].shape
        gate = name.rsplit(".", 1)[-1]
        if ".gru." in name:
            if gate.startswith("convz"):  # [z | r | q_x] over [h, x]
                self._note(name, n, c, h, w, 3 * o, kh, kw, stride)
            elif gate.startswith("convq"):  # q_h over r*h
                self._note(name, n, o, h, w, o, kh, kw, stride)
        else:
            self._note(name, n, c, h, w, o, kh, kw, stride)
        return super().conv(name, x, stride, padding)


def launches(model_cfg: Dict, params: Dict[str, torch.Tensor],
             precision: str, batch: int, height: int, width: int,
             iters: int) -> List[Launch]:
    """Every conv-kernel launch of one inference forward of ``batch``
    fields, in order; ``params``: the state dict (only shapes are read)."""
    c = model_cfg
    meta = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in params.items()}
    ref = _Counting(c, meta, precision)
    bins = c["nbins_context"] + c["nbins_correlation"] - 1
    vox = torch.empty(batch, height, width, bins, device="meta")
    img = torch.empty(2, batch, height, width, 3, device="meta")
    with torch.no_grad():
        ref.forward(vox, img, iters)
    return ref.launches


def per_kernel(found: List[Launch]) -> Dict[str, Dict[str, float]]:
    """{kernel: launches, operations, bytes, bound_s} summed over
    ``found``."""
    out: Dict[str, Dict[str, float]] = {}
    for ln in found:
        k = out.setdefault(ln.kernel, {"launches": 0, "operations": 0,
                                       "bytes": 0, "bound_s": 0.0})
        k["launches"] += 1
        k["operations"] += ln.operations
        k["bytes"] += ln.bytes
        k["bound_s"] += ln.bound_s
    return out
