"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it, and their launch counts."""

from __future__ import annotations

from typing import Dict

from bflow_tpu_torch.kernels import conv3x3, corr_lookup, norm, stem_conv

# kernel name -> (wrapper module, the name of its launch counter there)
KERNELS = {
    corr_lookup.NAME: (corr_lookup, "launches"),
    corr_lookup.BWD_NAME: (corr_lookup, "bwd_launches"),
    stem_conv.NAME: (stem_conv, "launches"),
    conv3x3.NAME: (conv3x3, "launches"),
    norm.NAME: (norm, "launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
