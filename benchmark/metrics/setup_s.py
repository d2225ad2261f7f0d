"""setup_s: process start to the first timed request (imports, weights
from the seed, kernel libraries, pools, warm-up)."""


def read(run):
    return run.setup_s
