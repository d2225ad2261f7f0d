"""voxelize_ms.*: device ms per window of the operations launched inside
the benchmark's call of streaming.window_grid in the traced slice."""


def read(run):
    s = run.slice
    if not s.get("range_calls", {}).get("voxelize") or not s["requests"]:
        return None
    return 1e3 * s["ranges"]["voxelize"] / s["requests"]
