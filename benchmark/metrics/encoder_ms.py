"""encoder_ms.*: device ms per field of the operations launched inside
the encoders' forward calls (fnet_ev, fnet_img, cnet) in the traced
slice."""


def read(run):
    s = run.slice
    if not s.get("range_calls", {}).get("encoder") or not s["units"]:
        return None
    return 1e3 * s["ranges"]["encoder"] / s["units"]
