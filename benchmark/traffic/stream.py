"""Streaming windows: raw events and two frames in, flows at the query
times out, one window at a time (closed loop, one client).

A request starts with its window in host memory: the events padded to the
capacity (x, y int32, polarity f32, t int32 in microseconds, valid), and
the two uint8 frames. It copies them to the device, rasterizes the merged
voxel grid there (``streaming.window_grid``), runs the test-mode forward
and reads ``flow_at(query_times)`` back into host memory. The grid of a
kept answer stays on the device until the comparison.

Inputs from the seed: the pool's event counts are the same evenly spaced
counts from ``events`` [lo, hi] for every seed, in a seeded order (so
every seed does the same work); coordinates, polarities and times are
uniform, times sorted within a window.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from benchmark import trace
from benchmark.counts.lookup_bytes import LookupBytes
from benchmark.counts.flops import forward_flops
from benchmark.program import generator, pinned, seeded_model
from benchmark.reference.lowp import rounding as make_rounding
from benchmark.reference.model import Reference, flow_at
from benchmark.reference.train import voxel_grid
from benchmark.traffic.base import Base, rel
from bflow_tpu_torch.streaming import window_grid

EVENT_FIELDS = ("x", "y", "p", "t", "valid")


class Cell(Base):
    def __init__(self, run):
        super().__init__(run)
        wl, dev = self.wl, self.dev
        self.model, self.sd = seeded_model(self.cfg, wl["precision"],
                                           run.seed, dev, wl["iters"])
        h, w = wl["height"], wl["width"]
        cap, pool = wl["capacity"], wl["pool"]
        lo, hi = wl["events"]
        t0, t1 = wl["window_us"]
        g = generator(run.seed, 1, dev)
        counts = torch.linspace(lo, hi, pool, device=dev).round().long()
        counts = counts[torch.randperm(pool, generator=g, device=dev)]
        valid = torch.arange(cap, device=dev)[None] < counts[:, None]

        def draw(high):
            v = torch.randint(0, high, (pool, cap), generator=g, device=dev,
                              dtype=torch.int32)
            return torch.where(valid, v, 0)

        x, y, p = draw(w), draw(h), draw(2).float()
        # the grid spans [t0 - (t1 - t0), t1]: events anywhere in it
        t = torch.randint(2 * t0 - t1, t1, (pool, cap), generator=g,
                          device=dev, dtype=torch.int32)
        t = torch.sort(torch.where(valid, t, t1), dim=1).values
        t = torch.where(valid, t, 0)
        frames = torch.randint(0, 256, (pool, 2, 1, h, w, 3), generator=g,
                               device=dev, dtype=torch.uint8)
        self.host = {k: pinned(v) for k, v in
                     zip(EVENT_FIELDS + ("frames",),
                         (x, y, p, t, valid, frames))}
        self.bounds = (torch.tensor(t0, device=dev),
                       torch.tensor(t1, device=dev))
        self.channels = self.model.config.nbins_total
        self.warm_up()

    def ranges(self):
        m = self.model
        enc = [getattr(m, n) for n in ("fnet_ev", "fnet_img", "cnet")
               if hasattr(m, n)]
        return trace.hook_ranges({"encoder": enc,
                                  "update": [m.update_block]})

    def request(self):
        wl, k = self.wl, self.i % self.wl["pool"]
        dev = self.dev
        ev = [self.host[n][k].to(dev, non_blocking=True)
              for n in EVENT_FIELDS]
        frames = self.host["frames"][k].to(dev, non_blocking=True)
        with trace.span("voxelize", self.tracing):
            grid = window_grid(*ev, *self.bounds, channels=self.channels,
                               height=wl["height"], width=wl["width"])
        _, up = self.model(grid[None], frames, iters=wl["iters"],
                           test_mode=True)
        flows = up.flow_at(tuple(wl["query_times"])).cpu()
        self.keep(k, (grid, flows))
        self.i += 1

    def release(self):
        self.free("model")

    # -- the comparison ----------------------------------------------------

    def reference(self, k: int, rounding: Optional[str] = None,
                  hook=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(voxel grid, flows) of the reference for pool entry k; the grid
        as the reference's convolutions take it, at ``rounding``."""
        wl, dev = self.wl, self.dev
        t0, t1 = wl["window_us"]
        ev = [self.host[n][k].to(dev) for n in EVENT_FIELDS]
        grid = voxel_grid(*ev, 2 * t0 - t1, t1, self.channels,
                          wl["height"], wl["width"])
        sd = {n: v.to(dev) for n, v in self.sd.items()}
        ref = Reference(self.cfg["model"], sd, rounding, hook)
        _, up = ref.forward(grid[None], self.host["frames"][k].to(dev),
                            wl["iters"])
        return (make_rounding(rounding)(grid),
                flow_at(up, wl["query_times"]).cpu())

    def judge(self, stand_in: Optional[Dict] = None) -> Dict[str, float]:
        """grid_rel: the widest relative L2 gap of a kept answer's voxel
        grid from the reference's (accumulated in f64, rounded to f32).
        flow_vs_bf16: the widest relative L2 gap of a kept answer's flows
        from the f32 reference's, over the gap of the reference itself with
        bf16 operands on the same window. The random-weight recurrence
        amplifies rounding by a factor that differs from seed to seed;
        the ratio cancels it, so a sound bf16 program reads ~1 on every
        seed. ``stand_in`` ({"rounding": ...}) judges the reference at that
        rounding in the program's place."""
        item = 2 if self.wl["precision"] == "bfloat16" else 4
        hook = LookupBytes(item)
        grid_worst = flow_worst = 0.0
        for k in sorted({e for e, _ in self.kept.values()}):
            grid, want = self.reference(k, hook=hook)
            scale = rel(self.reference(k, "bf16")[1], want)
            if stand_in is not None:
                answers = [self.reference(k, stand_in.get("rounding"))]
            else:
                answers = [a for e, a in self.kept.values() if e == k]
            for got_grid, flows in answers:
                grid_worst = max(grid_worst, rel(got_grid, grid))
                flow_worst = max(flow_worst, rel(flows, want) / scale)
        self.run.counts["lookup_bytes"] = hook.per_launch()
        return {"grid_rel": grid_worst, "flow_vs_bf16": flow_worst}

    def flops(self) -> float:
        """Operations of one request (one field)."""
        wl = self.wl
        return forward_flops(self.cfg["model"], self.sd, 1, wl["height"],
                             wl["width"], wl["iters"])
