"""corr_ms.*: device ms per field of the operations launched inside the
port's ``bflow.corr`` span (build_pyramid_for_method: the correlation
volumes and their pooled pyramid) in the traced slice."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, "corr", "device_s")
