"""Evaluation batches: what ``val`` runs per batch, back to back (closed
loop, one client).

A request starts with its batch in pinned host memory, as the loader
hands it over (voxel grids (B, H, W, bins) f32, frames (2, B, H, W, 3)
f32 in 0..255, ground-truth flow, DSEC's valid mask), copies it to the
device, runs ``train.make_eval_step`` (the test-mode forward, the
``val/*`` metrics, the prediction at the last supervision time) and reads
the metrics and the prediction back into host memory.

Inputs from the seed: normal voxel grids, uniform frames, ground truth
uniform in [-6, 6] px, 90% valid.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark import trace
from benchmark.counts.flops import forward_flops
from benchmark.counts.lookup_bytes import LookupBytes
from benchmark.program import generator, pinned, seeded_model
from benchmark.reference.model import Reference, flow_at
from benchmark.reference.train import epe
from benchmark.traffic.base import Base, rel
from bflow_tpu_torch.train.step import TaskConfig, make_eval_step


def task_of(wl: Dict) -> TaskConfig:
    t = wl["task"]
    return TaskConfig(t["dataset"], multi_loss=t.get("multi_loss", False),
                      supervision_timestamps=tuple(t.get("times", ())))


def seeded_batches(wl: Dict, bins: int, seed: int, device, stream: int):
    """The pool's batches in pinned host memory, drawn on the device."""
    b, h, w = wl["batch"], wl["height"], wl["width"]
    times = wl["task"].get("times")
    g = generator(seed, stream, device)
    pool = []
    for _ in range(wl["pool"]):
        batch = {
            "ev_repr": torch.randn(b, h, w, bins, generator=g, device=device),
            "img": torch.randint(0, 256, (2, b, h, w, 3), generator=g,
                                 device=device).float(),
            "flow": 12.0 * torch.rand(
                ((len(times),) if times else ()) + (b, h, w, 2),
                generator=g, device=device) - 6.0,
        }
        if not times:
            batch["flow_valid"] = torch.rand(b, h, w, generator=g,
                                             device=device) < 0.9
        pool.append({k: pinned(v) for k, v in batch.items()})
    return pool


class Cell(Base):
    def __init__(self, run):
        super().__init__(run)
        wl = self.wl
        self.units = wl["batch"]
        self.model, self.sd = seeded_model(self.cfg, wl["precision"],
                                           run.seed, self.dev, wl["iters"])
        self.step = make_eval_step(self.model, task_of(wl))
        self.metric = wl["task"]["metric"]
        self.pool = seeded_batches(wl, self.model.config.nbins_total,
                                   run.seed, self.dev, 1)
        self.warm_up()

    def ranges(self):
        m = self.model
        enc = [getattr(m, n) for n in ("fnet_ev", "fnet_img", "cnet")
               if hasattr(m, n)]
        return trace.hook_ranges({"encoder": enc,
                                  "update": [m.update_block]})

    def request(self):
        k = self.i % self.wl["pool"]
        batch = {n: v.to(self.dev, non_blocking=True)
                 for n, v in self.pool[k].items()}
        metrics, pred, _ = self.step(batch)
        value = metrics[self.metric][0].cpu()
        self.keep(k, (float(value), pred.cpu()))
        self.i += 1

    def release(self):
        self.free("model", "step")

    # -- the comparison ----------------------------------------------------

    def reference(self, k: int, rounding: Optional[str] = None, hook=None):
        """(metric, prediction at the last supervision time) of the
        reference for pool entry k."""
        wl, dev = self.wl, self.dev
        batch = {n: v.to(dev) for n, v in self.pool[k].items()}
        sd = {n: v.to(dev) for n, v in self.sd.items()}
        ref = Reference(self.cfg["model"], sd, rounding, hook)
        _, up = ref.forward(batch["ev_repr"], batch["img"], wl["iters"])
        times = wl["task"].get("times")
        if times:
            metric = epe(flow_at(up, times), batch["flow"])
        else:
            metric = epe(flow_at(up, [1.0]), batch["flow"][None],
                         batch["flow_valid"])
        return metric, flow_at(up, [(times or [1.0])[-1]])[0].cpu()

    def judge(self, stand_in: Optional[Dict] = None) -> Dict[str, float]:
        """The widest gaps of the kept answers from the f32 reference's:
        flow_rel, the relative L2 gap of a prediction; metric_rel, the
        relative gap of the cell's metric (DSEC's val/epe, MultiFlow's
        val/epe_multi).

        A bfloat16 cell also reads each gap over the same gap of the
        reference itself with bf16 operands on the same batch:
        flow_vs_bf16 and metric_vs_bf16 (``stream.py``'s yardstick: the
        random-weight recurrence amplifies rounding by a factor that
        differs from seed to seed, and the ratio cancels it, so a sound
        bf16 program reads ~1). The workload's ``limits`` name the numbers
        compared.

        ``stand_in`` ({"rounding": ...}) judges the reference at that
        rounding in the program's place."""
        low = self.wl["precision"] == "bfloat16"
        hook = LookupBytes(2 if low else 4)
        worst: Dict[str, float] = {}
        for k in sorted({e for e, _ in self.kept.values()}):
            m_ref, p_ref = self.reference(k, hook=hook)
            if low:
                m_bf, p_bf = self.reference(k, "bf16")
            if stand_in is not None:
                answers = [self.reference(k, stand_in.get("rounding"))]
            else:
                answers = [a for e, a in self.kept.values() if e == k]
            for m, p in answers:
                gaps = {"flow_rel": rel(p, p_ref),
                        "metric_rel": abs(m - m_ref) / max(abs(m_ref), 1e-30)}
                if low:
                    gaps["flow_vs_bf16"] = gaps["flow_rel"] / rel(p_bf, p_ref)
                    gaps["metric_vs_bf16"] = abs(m - m_ref) / max(
                        abs(m_bf - m_ref), 1e-30)
                for name, gap in gaps.items():
                    worst[name] = max(worst.get(name, 0.0), gap)
        self.run.counts["lookup_bytes"] = hook.per_launch()
        return worst

    def flops(self) -> float:
        """Operations of one request (a batch)."""
        wl = self.wl
        return forward_flops(self.cfg["model"], self.sd, wl["batch"],
                             wl["height"], wl["width"], wl["iters"])
