"""forward_ms.*: device ms per training step of the operations launched
inside the model's forward call (the rest of a step is backward,
optimizer and schedule) in the traced slice."""


def read(run):
    s = run.slice
    if not s.get("range_calls", {}).get("forward") or not s["requests"]:
        return None
    return 1e3 * s["ranges"]["forward"] / s["requests"]
