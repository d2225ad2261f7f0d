"""The program under test, built from the seed: the model with seeded
weights made on the device, and the seeded generators of the inputs.

Weights: the model is built on the meta device and given memory on the
run's device, then every convolution's weight is drawn in one normal draw
for all of them (He/Kaiming with fan-out, gain 2, the draw clipped at
two standard deviations, as the port's own initialisation truncates
there), every bias in one uniform draw (+-1/sqrt(fan-in)), BatchNorm at
scale 1, shift 0, statistics (0, 1). Then the configuration's
``weight_scale`` entries are applied (the Bezier head's last weight x0.02,
so that the random-init recurrence is contractive, as a trained one is).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from bflow_tpu_torch.models import RAFTSpline, RaftSplineConfig

_TRUNC_STD = 0.87962566103423978  # std of a normal truncated to [-2, 2]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator per (seed, stream) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def model_config(config: Dict, precision: str, iters: int
                 ) -> RaftSplineConfig:
    """The port's config from the configuration file's ``model`` section,
    with correlation and compute at ``precision`` and ``iters``
    refinement steps in training and inference."""
    fields = {f.name for f in dataclasses.fields(RaftSplineConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["model"].items() if k in fields}
    kw.update(corr_precision=precision, compute_dtype=precision,
              iters_train=iters, iters_test=iters)
    return RaftSplineConfig(**kw)


@torch.no_grad()
def seeded_model(config: Dict, precision: str, seed: int, device,
                 iters: int) -> Tuple[RAFTSpline, Dict[str, torch.Tensor]]:
    """(model in eval mode on ``device``, its state dict on the host)."""
    with torch.device("meta"):
        model = RAFTSpline(model_config(config, precision, iters))
    model = model.to_empty(device=device)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    g = generator(seed, 0, device)
    normal = torch.randn(sum(m.weight.numel() for m in convs), generator=g,
                         device=device)
    unif = torch.rand(sum(m.bias.numel() for m in convs), generator=g,
                      device=device)
    i = j = 0
    for m in convs:
        w, b = m.weight, m.bias
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
        w.copy_(normal[i:i + w.numel()].view_as(w).clamp(-2.0, 2.0) * std)
        b.copy_((2.0 * unif[j:j + b.numel()] - 1.0) / math.sqrt(fan_in))
        i += w.numel()
        j += b.numel()
    for m in norms:
        m.weight.fill_(1.0)
        m.bias.zero_()
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
        m.num_batches_tracked.zero_()
    covered = {id(p) for m in convs + norms for p in m.parameters()}
    missing = [n for n, p in model.named_parameters() if id(p) not in covered]
    if missing:
        raise RuntimeError(f"no seeded draw for {missing}")
    params = dict(model.named_parameters())
    for name, scale in config.get("weight_scale", {}).items():
        params[name].mul_(scale)
    model.eval()
    return model, {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}


def pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy in page-locked memory (plain memory on a CPU run)."""
    if t.device.type == "cpu":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host
