"""What every traffic kind's ``Cell`` shares: the run's device, the kept
answers, draining and freeing the program.

A cell keeps, for the comparison after the window, the newest answer of
every pool entry (so every distinct input the window served is judged)
and the answers of a few requests drawn from the seed among the window's
first 64.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, Tuple

import torch

SAMPLED = 3  # requests drawn from the seed, besides each entry's newest


class Base:
    units = 1  # fields or samples a request completes
    tracing = False  # set by the traced slice

    def __init__(self, run):
        self.run = run
        self.wl = run.workload
        self.cfg = run.config
        self.dev = torch.device(run.device)
        self.i = 0  # requests served, warm-up included
        g = torch.Generator().manual_seed(int(run.seed) % (1 << 63))
        first = self.wl.get("warmup", 0)  # training keeps no answers
        self.sampled = {first + int(j) for j in
                        torch.randperm(64, generator=g)[:SAMPLED]}
        self.kept: Dict[Tuple, Tuple] = {}

    def keep(self, entry: int, answer) -> None:
        self.kept[("newest", entry)] = (entry, answer)
        if self.i in self.sampled:
            self.kept[("request", self.i)] = (entry, answer)

    def warm_up(self) -> None:
        for _ in range(self.wl["warmup"]):
            self.request()
        self.drain()

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def ranges(self):
        return contextlib.nullcontext()

    def free(self, *names: str) -> None:
        """Drop the program's objects and give their memory back."""
        for n in names:
            setattr(self, n, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in f64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).norm() / want.norm().clamp(min=1e-30))
