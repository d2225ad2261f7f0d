"""lookup_bwd_roofline.*: as lookup_roofline, for the backward kernel."""

from bflow_tpu_torch.kernels.corr_lookup import BWD_NAME

from benchmark.metrics.lookup_roofline import roofline


def read(run):
    return roofline(run, BWD_NAME, "bwd")
