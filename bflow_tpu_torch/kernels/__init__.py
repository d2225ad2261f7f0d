"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it, and their launch counts."""

from __future__ import annotations

from typing import Dict

from bflow_tpu_torch.kernels import corr_lookup

# kernel name -> wrapper module, which keeps a `launches` count
KERNELS = {corr_lookup.NAME: corr_lookup}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
