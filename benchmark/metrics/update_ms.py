"""update_ms.*: device ms per field of the operations launched inside the
update block's calls (12 a field) in the traced slice."""


def read(run):
    s = run.slice
    if not s.get("range_calls", {}).get("update") or not s["units"]:
        return None
    return 1e3 * s["ranges"]["update"] / s["units"]
