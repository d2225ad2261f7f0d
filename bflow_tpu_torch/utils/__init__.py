"""Losses, metrics and input padding of the port (counterparts of
bflow_tpu/utils)."""
