"""mfu.*: the operations of the requests completed in the window (counted
by counts/flops.py on the reference) over the window's seconds times the
peak at the cell's precision, in %."""

from benchmark.counts.peaks import FLOPS


def read(run):
    flops = run.counts.get("flops")
    done = run.requests - run.failed
    if not flops or not done or run.window_s <= 0:
        return None
    peak = FLOPS[run.workload["precision"]]
    return 100.0 * flops * done / (run.window_s * peak)
