"""Named-timer registry with an atexit summary (the port's counterpart of
bflow_tpu/utils/timers.py). `DeviceTimer` times the block's work on the
current CUDA stream with a pair of CUDA events and waits for the second,
where the JAX package blocks until its outputs are ready; without CUDA it
takes the host's wall time. `TimerDummy` compiles instrumentation out.
The summary is printed at exit when a timer has recorded anything.
"""

from __future__ import annotations

import atexit
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

cuda_timers: Dict[str, List[float]] = defaultdict(list)
timers: Dict[str, List[float]] = defaultdict(list)


class DeviceTimer:
    """Seconds of a block's device work (CUDA events on the current
    stream), or its wall time where CUDA is not initialized."""

    def __init__(self, timer_name: str = ""):
        assert timer_name
        self.name = timer_name
        self.start: Optional[float] = None
        self._events = None

    def __enter__(self):
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start = time.time()
        return self

    def __exit__(self, *args):
        if self._events is None:
            cuda_timers[self.name].append(time.time() - self.start)
            return
        start, end = self._events
        end.record()
        end.synchronize()
        cuda_timers[self.name].append(start.elapsed_time(end) / 1e3)


class Timer:
    def __init__(self, timer_name: str = ""):
        assert timer_name
        self.name = timer_name
        self.start: Optional[float] = None

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *args):
        timers[self.name].append(time.time() - self.start)


class TimerDummy:
    """No-op stand-in: swap the import to compile timing out entirely."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass


def print_timing_info(warmup_iters: int = 2) -> None:
    print("== Timing statistics ==")
    for name, values in {**cuda_timers, **timers}.items():
        vals = values[warmup_iters:] if len(values) > warmup_iters else values
        if not vals:
            continue
        mean_ms = 1000.0 * sum(vals) / len(vals)
        print(f"{name}: mean {mean_ms:.2f} ms over {len(vals)} samples")


def _summary_at_exit() -> None:
    if any(cuda_timers.values()) or any(timers.values()):
        print_timing_info()


atexit.register(_summary_at_exit)
