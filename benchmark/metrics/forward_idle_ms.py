"""forward_idle_ms.*: ms per field (.eval) or per step (.train) in which
the device ran nothing while the port's ``bflow.forward`` span
(RAFTSpline.forward) was open in the traced slice: the host's launch
queue, what a CUDA graph of the forward can remove."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "forward", "idle_s")
