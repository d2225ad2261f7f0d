"""Large host buffers reused instead of mapped anew for each batch.

An evaluation on the GPU reads its prediction back into host memory batch
after batch (``val``'s media, a submission writer, a check against a
reference): at DSEC's 480x640 and B=16 one (N, H, W, 2) f32 flow is
39.3 MB. glibc's malloc serves a request above its mmap threshold with a
fresh mapping and unmaps it again on free; the threshold adapts to freed
sizes, but only up to 32 MiB. So from B=16 on, every read-back faults its
~9,600 pages in anew: 20-26 ms a batch on an H100 host's CPU against
4.6-5.7 ms when the buffer is reused, at a pace that follows the host's
load.

``reuse_large_host_buffers`` raises the mmap threshold to 256 MiB and the
trim threshold to 512 MiB for the process: a freed buffer of up to
256 MiB goes back to the heap, and a later one of its size reuses its
pages after a few batches (an aligned request takes a little more than
the chunk it freed, until freed neighbours merge). The heap keeps at most
512 MiB free at its top. Elsewhere than glibc it does nothing.
"""

from __future__ import annotations

import ctypes
import platform

M_TRIM_THRESHOLD = -1  # glibc's mallopt parameters (malloc.h)
M_MMAP_THRESHOLD = -3
MMAP_THRESHOLD = 256 << 20
TRIM_THRESHOLD = 512 << 20


def reuse_large_host_buffers() -> bool:
    """Set glibc's mmap and trim thresholds for the process (a second call
    sets the same values). Returns whether glibc took both."""
    if platform.libc_ver()[0] != "glibc":
        return False
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    return bool(mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD)) and bool(
        mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD))
