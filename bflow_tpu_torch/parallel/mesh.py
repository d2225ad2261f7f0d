"""The data axis: a rank's slice of a global batch, and replicated state.

Counterpart of bflow_tpu/parallel/mesh.py. There the batch is one global
array sharded over a 1-D 'data' mesh and the state is replicated by its
sharding; here every rank holds its slice of the batch as its own tensors
and a copy of the model, and DDP all-reduces the gradients
(train/step.py). ``shard_batch`` cuts the global batch as the JAX
sharding lays it out: rank r holds the r-th of ``world`` contiguous blocks
of the batch axis. In a training run each rank loads only its own slice
(the loaders' ``shard=(rank, world)``); ``shard_batch`` serves callers
that hold the whole batch in every process, the tests and the dry run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from bflow_tpu_torch.data.keys import DataLoading as K
from bflow_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
)


def batch_axis(key: str, leaf) -> int:
    """The batch axis of a batch leaf, by key as mesh.py:67-73 has it:
    IMG's (2, N, ...) and a 5-D MultiFlow FLOW's (M, N, ...) is 1, every
    other key's 0."""
    if key == K.IMG.value and leaf.ndim >= 4:
        return 1
    if key == K.FLOW.value and leaf.ndim == 5:
        return 1
    return 0


def shard_batch(batch: Dict[str, Any], rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict[str, Any]:
    """Rank ``rank``'s slice of a global batch (default: this process's
    rank of the process group). Leaves without a batch axis (scalars,
    nested dicts) are kept whole."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world

    def place(key, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return leaf
        axis = batch_axis(key, leaf)
        n = leaf.shape[axis]
        assert n % world == 0, (key, n, world)
        per = n // world
        index = [slice(None)] * leaf.ndim
        index[axis] = slice(rank * per, (rank + 1) * per)
        return leaf[tuple(index)]

    return {k: place(k, v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every rank's parameters and buffers become rank 0's (in place; a
    no-op without a process group)."""
    if is_initialized():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module
