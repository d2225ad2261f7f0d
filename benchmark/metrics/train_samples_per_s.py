"""train_samples_per_s: samples of the optimizer steps completed in the
window, over the window's wall (drained at its end)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
