"""conv_layout_ms.*: device ms per field of the operations launched
inside the port's ``bflow.conv_layout`` span (conv_common.kernel_input:
an activation copied into the conv kernels' layout, its channels padded
to a multiple of 8) in the traced slice."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "conv_layout", "device_s")
