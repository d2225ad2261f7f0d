"""Operations of one request, counted on the meta device.

The reference runs at the cell's shapes on meta tensors (no memory, no
device) under ``torch.utils.flop_counter.FlopCounterMode``, which counts
the convolutions and matrix products, forward and backward: the same
count whatever implements the work. Element-wise work, norms, the lookup
and the voxelizer are not counted, so the share of the peak is a lower
bound.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import Reference
from benchmark.reference.train import dsec_loss, is_buffer, multi_loss


def _meta(sd: Dict[str, torch.Tensor], grad: bool):
    return {k: torch.empty(v.shape, dtype=torch.float32, device="meta",
                           requires_grad=grad and not is_buffer(k))
            for k, v in sd.items()}


def forward_flops(model_cfg: Dict, sd: Dict[str, torch.Tensor], batch: int,
                  height: int, width: int, iters: int) -> int:
    """One inference forward of ``batch`` fields."""
    c = model_cfg
    ref = Reference(c, _meta(sd, False))
    bins = c["nbins_context"] + c["nbins_correlation"] - 1
    vox = torch.empty(batch, height, width, bins, device="meta")
    img = torch.empty(2, batch, height, width, 3, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(vox, img, iters)
    return fc.get_total_flops()


def train_flops(model_cfg: Dict, sd: Dict[str, torch.Tensor], batch: int,
                height: int, width: int, iters: int, gamma: float,
                times: Optional[Sequence[float]] = None) -> int:
    """One training step's forward and backward (``times``: MultiFlow's
    supervision times; None: DSEC's masked loss)."""
    c = model_cfg
    p = _meta(sd, True)
    ref = Reference(c, p)
    bins = c["nbins_context"] + c["nbins_correlation"] - 1
    vox = torch.empty(batch, height, width, bins, device="meta")
    img = torch.empty(2, batch, height, width, 3, device="meta")
    leaves = [v for v in p.values() if v.requires_grad]
    with FlopCounterMode(display=False) as fc:
        preds = ref.forward(vox, img, iters, train=True)
        if times:
            flows = torch.empty(len(times), batch, height, width, 2,
                                device="meta")
            loss = multi_loss(preds, flows, times, gamma)
        else:
            flow = torch.empty(batch, height, width, 2, device="meta")
            valid = torch.empty(batch, height, width, dtype=torch.bool,
                                device="meta")
            loss = dsec_loss(preds, flow, valid, gamma)
        torch.autograd.grad(loss, leaves)
    return fc.get_total_flops()
