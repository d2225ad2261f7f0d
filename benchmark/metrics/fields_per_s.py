"""fields_per_s: flow fields whose batch's outputs are back in host
memory, over the window's wall (drained at its end)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
