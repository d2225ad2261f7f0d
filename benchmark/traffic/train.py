"""Training steps: ``train.make_train_step`` with the port's optimizer and
schedule, back to back (closed loop), with no host read-back between
steps, as a training loop runs between its log steps.

A request takes its batch from a pool in pinned host memory (the layouts
of eval.py, at the training crop), copies it to the device and runs one
step: the train-mode forward over every iteration, the sequence loss,
backward, the gradient clamp, AdamW and one scheduler step.

Set-up builds one training object (model, optimizer, schedule, step) and
drives it from the seed through the first ``checked_steps`` steps, each
on another pool batch, through the same request; the window then goes on
with that object. The comparison follows those first steps with the
reference: each step's loss, the first gradient as the optimizer got it
(its first moment after one step over 1 - b1) and the parameters' change
after the last checked step, leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark import trace
from benchmark.counts.flops import train_flops
from benchmark.counts.lookup_bytes import LookupBytes
from benchmark.program import seeded_model
from benchmark.reference.model import Reference, f32
from benchmark.reference.train import (AdamW, dsec_loss, leaf_norms,
                                       multi_loss, sorted_median, split_state)
from benchmark.traffic.base import Base
from benchmark.traffic.eval import seeded_batches, task_of
from bflow_tpu_torch.train.optimizer import build_optimizer
from bflow_tpu_torch.train.step import make_train_step, train_metric_keys

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: their change is not compared
ZERO_GRAD_SHARE = 1e-3


def _norms(tensors) -> Dict[str, float]:
    """Per-leaf f64 norms, read back in one transfer."""
    names = list(tensors)
    host = torch.stack([tensors[n].detach().double().norm()
                        for n in names]).cpu()
    return dict(zip(names, host.tolist()))


def _half(batch: Dict, n: int) -> Dict:
    """The first n samples of a batch (the batch axis of each key)."""
    axis = {"ev_repr": 0, "img": 1, "flow_valid": 0}
    out = {}
    for k, v in batch.items():
        a = axis.get(k, 1 if v.dim() == 5 else 0)
        out[k] = v.narrow(a, 0, n)
    return out


class Cell(Base):
    def __init__(self, run):
        super().__init__(run)
        wl, dev = self.wl, self.dev
        self.units = wl["batch"]
        self.model, self.sd = seeded_model(self.cfg, wl["precision"],
                                           run.seed, dev, wl["iters"])
        task = task_of(wl)
        self.opt, self.sched = build_optimizer(self.cfg["training"],
                                               self.model.parameters())
        self.step = make_train_step(self.model, task, self.opt, self.sched)
        self.pool = seeded_batches(wl, self.model.config.nbins_total,
                                   run.seed, dev, 1)
        key = train_metric_keys(task)[0]
        params = dict(self.model.named_parameters())
        b1 = self.opt.param_groups[0]["betas"][0]
        self.losses = []
        for s in range(wl["checked_steps"]):
            out = self.request()
            self.losses.append(float(out[key][0]))
            if s == 0:
                self.grads = {n: v / (1.0 - b1) for n, v in _norms(
                    {n: self.opt.state[p]["exp_avg"]
                     for n, p in params.items()}).items()}
        self.change = _norms({n: p - self.sd[n].to(dev)
                              for n, p in params.items()})
        self.drain()

    def ranges(self):
        return trace.hook_ranges({"forward": [self.model]})

    def request(self):
        batch = {n: v.to(self.dev, non_blocking=True)
                 for n, v in self.pool[self.i % self.wl["pool"]].items()}
        self.i += 1
        return self.step(batch)

    def release(self):
        self.free("model", "opt", "sched", "step")

    # -- the comparison ----------------------------------------------------

    def reference(self, rounding: Optional[str] = None, half: bool = False,
                  hook=None):
        """The reference's (losses, first clamped gradients' norms, change
        norms) over the checked steps; ``half`` leaves out the second half
        of every batch (a fault)."""
        leaves, bufs = split_state(self.sd, self.dev)
        ref = Reference(self.cfg["model"], {**leaves, **bufs}, rounding,
                        hook)
        opt = AdamW(leaves, self.cfg["training"])
        with f32():  # the backward too: it runs outside the forward
            losses, grads = self._steps(ref, opt, leaves, half)
        change = leaf_norms({n: leaves[n].detach() - self.sd[n].to(self.dev)
                             for n in leaves})
        return losses, grads, change

    def _steps(self, ref, opt, leaves, half):
        wl, dev = self.wl, self.dev
        times = wl["task"].get("times")
        gamma = wl["task"].get("gamma", 0.8)
        losses, grads = [], None
        for s in range(wl["checked_steps"]):
            batch = {n: v.to(dev) for n, v in
                     self.pool[s % wl["pool"]].items()}
            if half:
                batch = _half(batch, wl["batch"] // 2)
            preds = ref.forward(batch["ev_repr"], batch["img"], wl["iters"],
                                train=True)
            if times:
                loss = multi_loss(preds, batch["flow"], times, gamma)
            else:
                loss = dsec_loss(preds, batch["flow"], batch["flow_valid"],
                                 gamma)
            g = torch.autograd.grad(loss, list(leaves.values()))
            used = opt.step(dict(zip(leaves, g)))
            losses.append(float(loss.detach()))
            if s == 0:
                grads = leaf_norms(used)
            del preds, loss, g, used
        return losses, grads

    def judge(self, stand_in: Optional[Dict] = None) -> Dict[str, float]:
        """loss_rel: the widest relative gap of a checked step's loss;
        grad_leaf and change_leaf: the widest gap of a leaf's norm (the
        first gradient's, the change's) over the larger of the reference
        leaf's norm and the median leaf's. Leaves whose reference gradient
        is under ZERO_GRAD_SHARE of the median's are left out of the
        change."""
        hook = LookupBytes(2 if self.wl["precision"] == "bfloat16" else 4)
        losses, grads, change = self.reference(hook=hook)
        self.run.counts["lookup_bytes"] = hook.per_launch()
        if stand_in is None:
            got = (self.losses, self.grads, self.change)
        else:
            got = self.reference(stand_in.get("rounding"),
                                 stand_in.get("half", False))
        g_med = sorted_median(list(grads.values()))
        c_med = sorted_median(list(change.values()))
        moved = [n for n in grads if grads[n] >= ZERO_GRAD_SHARE * g_med]
        grad_gap = {n: abs(got[1][n] - grads[n]) / max(grads[n], g_med)
                    for n in grads}
        change_gap = {n: abs(got[2][n] - change[n]) / max(change[n], c_med)
                      for n in moved}
        self.run.counts.update(
            leaves_compared=[len(moved), len(grads)],
            worst_leaf=[max(grad_gap, key=grad_gap.get),
                        max(change_gap, key=change_gap.get)])
        return {"loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(got[0], losses)),
                "grad_leaf": max(grad_gap.values()),
                "change_leaf": max(change_gap.values())}

    def flops(self) -> float:
        """Operations of one request (a training step)."""
        wl = self.wl
        return train_flops(self.cfg["model"], self.sd, wl["batch"],
                           wl["height"], wl["width"], wl["iters"],
                           wl["task"].get("gamma", 0.8),
                           wl["task"].get("times"))
