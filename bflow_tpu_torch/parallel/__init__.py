"""Data-parallel training of the port (counterpart of bflow_tpu/parallel):
``distributed`` (process group, ranks, the all-reduce, spawning ranks),
``mesh`` (a rank's slice of a global batch, replicated state) and
``dryrun`` (one training step over n ranks)."""
