"""loss_idle_ms.*: ms per step in which the device ran nothing while the
port's ``bflow.loss`` span (make_loss_fn after the forward) was open in
the traced slice."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "loss", "idle_s")
