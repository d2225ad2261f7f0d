"""idle_share.*: the share of the traced slice's wall in which no
operation (kernel, copy, fill) ran on the device, in %."""


def read(run):
    s = run.slice
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
