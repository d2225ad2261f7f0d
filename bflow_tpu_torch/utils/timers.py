"""Named-timer registry with an atexit summary (the port's counterpart of
bflow_tpu/utils/timers.py), and the program's spans.

``span(name)`` marks a phase of the program (``bflow.<name>``) in the
trace of a running torch.profiler: a ``user_annotation`` event on the same
clock as the device activity, so a device idle gap can be put down to the
span the host was in. The profiler keeps the spans in memory and writes
them out when it stops. With no profiler running, ``span`` returns a
shared null context: the check costs ~0.2 us a call, where a
``record_function`` costs ~9 us on the H100 machine's host even when
nothing records it.

`DeviceTimer` times the block's work on the current CUDA stream with a
pair of CUDA events, where the JAX package blocks until its outputs are
ready; it does not wait for the device: the pairs are resolved once, by
the summary (``print_timing_info``). Without CUDA it takes the host's wall
time. `Timer` and `DeviceTimer` open a span of their own name.
`TimerDummy` compiles instrumentation out. The summary is printed at exit
when a timer has recorded anything.
"""

from __future__ import annotations

import atexit
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bflow."
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled

cuda_timers: Dict[str, List[float]] = defaultdict(list)
timers: Dict[str, List[float]] = defaultdict(list)
# DeviceTimer blocks whose device time is not read yet: (name, start, end)
_pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []


def span(name: str, args=None):
    """A ``bflow.<name>`` range while a torch.profiler records, else the
    shared null context. ``args`` identifies the call (a step's number):
    the profiler's trace keeps no ``record_function`` arguments, so it is
    appended to the name after a ``#`` (``bflow.step#7``)."""
    if not _profiler_enabled():
        return _NULL
    if args is not None:
        name = f"{name}#{args}"
    return torch.profiler.record_function(PREFIX + name)


class DeviceTimer:
    """Seconds of a block's device work (CUDA events on the current
    stream, read at the summary), or its wall time where CUDA is not
    initialized."""

    def __init__(self, timer_name: str = ""):
        assert timer_name
        self.name = timer_name
        self.start: Optional[float] = None
        self._events = None

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start = time.time()
        return self

    def __exit__(self, *args):
        if self._events is None:
            cuda_timers[self.name].append(time.time() - self.start)
        else:
            self._events[1].record()
            _pending.append((self.name, *self._events))
        self._span.__exit__(*args)


class Timer:
    def __init__(self, timer_name: str = ""):
        assert timer_name
        self.name = timer_name
        self.start: Optional[float] = None

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self.start = time.time()
        return self

    def __exit__(self, *args):
        timers[self.name].append(time.time() - self.start)
        self._span.__exit__(*args)


class TimerDummy:
    """No-op stand-in: swap the import to compile timing out entirely."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass


def _resolve() -> None:
    """Move the DeviceTimer blocks' device times into cuda_timers: the
    first pair waits for the device, the rest are done by then."""
    for name, start, end in _pending:
        end.synchronize()
        cuda_timers[name].append(start.elapsed_time(end) / 1e3)
    _pending.clear()


def print_timing_info(warmup_iters: int = 2) -> None:
    _resolve()
    print("== Timing statistics ==")
    for name, values in {**cuda_timers, **timers}.items():
        vals = values[warmup_iters:] if len(values) > warmup_iters else values
        if not vals:
            continue
        mean_ms = 1000.0 * sum(vals) / len(vals)
        print(f"{name}: mean {mean_ms:.2f} ms over {len(vals)} samples")


def _summary_at_exit() -> None:
    if _pending or any(cuda_timers.values()) or any(timers.values()):
        print_timing_info()


atexit.register(_summary_at_exit)
