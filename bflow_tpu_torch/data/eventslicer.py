"""Time-window slicing of DSEC event HDF5 files (copy of
bflow_tpu/data/eventslicer.py).

The `ms_to_idx` coarse index narrows the read to a conservative
millisecond window, then an exact refinement selects
t_start_us <= t < t_end_us by `np.searchsorted` on the sorted timestamps.
The file handle is an h5py File or the port's own reader
(bflow_tpu_torch/data/hdf5.py): both slice datasets by rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np


class EventSlicer:
    def __init__(self, h5f):
        self.h5f = h5f
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        # ms_to_idx[ms] = first event index with t >= ms*1000 (us).
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = int(h5f["t_offset"][()])
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_start_time_us(self) -> int:
        return self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    def get_events(
        self, t_start_us: int, t_end_us: int
    ) -> Optional[Dict[str, np.ndarray]]:
        """Events with t_start_us <= t < t_end_us, or None if the window
        exceeds the coarse index range."""
        assert t_start_us < t_end_us
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset

        ms_lo, ms_hi = self.get_conservative_window_ms(t_start_us, t_end_us)
        idx_lo = self.ms2idx(ms_lo)
        idx_hi = self.ms2idx(ms_hi)
        if idx_lo is None or idx_hi is None:
            return None

        t_cons = np.asarray(self.events["t"][idx_lo:idx_hi])
        off_lo, off_hi = self.get_time_indices_offsets(
            t_cons, t_start_us, t_end_us
        )
        lo = idx_lo + off_lo
        hi = idx_lo + off_hi
        out = {"t": t_cons[off_lo:off_hi] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][lo:hi])
            assert out[k].size == out["t"].size
        return out

    @staticmethod
    def get_conservative_window_ms(
        ts_start_us: int, ts_end_us: int
    ) -> Tuple[int, int]:
        assert ts_end_us > ts_start_us
        return math.floor(ts_start_us / 1000), math.ceil(ts_end_us / 1000)

    @staticmethod
    def get_time_indices_offsets(
        time_array: np.ndarray, time_start_us: int, time_end_us: int
    ) -> Tuple[int, int]:
        """First index with t >= start, first index with t >= end."""
        assert time_array.ndim == 1
        if time_array.size == 0 or time_array[-1] < time_start_us:
            return time_array.size, time_array.size
        lo = int(np.searchsorted(time_array, time_start_us, side="left"))
        hi = int(np.searchsorted(time_array, time_end_us, side="left"))
        return lo, hi

    def ms2idx(self, time_ms: int) -> Optional[int]:
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return int(self.ms_to_idx[time_ms])
