"""lookup_roofline.*: the forward lookup kernel's bound time (bytes per
launch from counts/lookup_bytes.py at the HBM peak) over its device time
in the traced slice, in %. Nothing when the slice ran no such kernel."""

from benchmark.counts.peaks import HBM_BYTES_PER_S
from bflow_tpu_torch.kernels.corr_lookup import NAME


def roofline(run, kernel: str, direction: str):
    per_launch = run.counts.get("lookup_bytes", {}).get(direction)
    launches, seconds = 0, 0.0
    for name, (n, s) in run.slice.get("kernels", {}).items():
        if kernel in name:
            launches += n
            seconds += s
    if not launches or not per_launch or seconds <= 0:
        return None
    return 100.0 * launches * per_launch / HBM_BYTES_PER_S / seconds


def read(run):
    return roofline(run, NAME, "fwd")
