"""Data-parallel training of the port (counterpart of bflow_tpu/parallel):
``distributed`` (process group, ranks, the all-reduce, spawning ranks),
``mesh`` (a rank's slice of a global batch, replicated state) and
``dryrun`` (one training step over n ranks)."""

from bflow_tpu_torch.parallel.mesh import replicate, shard_batch

__all__ = ["replicate", "shard_batch"]
