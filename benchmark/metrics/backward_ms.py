"""backward_ms.*: device ms per step of the operations launched inside
the port's ``bflow.backward`` span (loss.backward(), autograd's own
thread included) in the traced slice."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "backward", "device_s")
