"""stem_roofline.*: as conv3x3_roofline, for the stride-2 stem kernel
(``conv_igemm_kernel<2, ...>`` in the trace)."""

from benchmark.counts import conv_ops
from benchmark.metrics.conv3x3_roofline import roofline


def read(run):
    return roofline(run, conv_ops.STEM)
