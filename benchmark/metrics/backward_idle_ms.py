"""backward_idle_ms.*: ms per step in which the device ran nothing while
the port's ``bflow.backward`` span was open in the traced slice."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "backward", "idle_s")
