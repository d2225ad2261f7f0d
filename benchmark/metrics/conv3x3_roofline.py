"""conv3x3_roofline.*: the conv3x3 kernel's bound time over its device
time in the traced slice, in %. The bound is that of every launch the
slice's forwards make (counts/conv_ops.py: the reference's convs at the
cell's shapes, each launch max(operations / bf16 peak, bytes / HBM
peak)); the device time is that of the kernels the trace names
``conv_igemm_kernel<1, ...>`` (the template's first argument is the
stride: 1 here, 2 for the stem kernel). Nothing when the slice ran no
such kernel, or other than the count's launches times its forwards."""

import re

import torch

from benchmark.counts import conv_ops
from benchmark.program import model_config
from bflow_tpu_torch.models import RAFTSpline

KERNEL = re.compile(r"conv_igemm_kernel<\s*(\d+)\s*,")


def counted(run):
    """conv_ops.per_kernel of one request of the run's cell, counted once
    a run (kept in run.counts)."""
    if "conv_ops" not in run.counts:
        wl = run.workload
        with torch.device("meta"):
            model = RAFTSpline(model_config(run.config, wl["precision"],
                                            wl["iters"]))
        found = conv_ops.launches(run.config["model"], model.state_dict(),
                                  wl["precision"], wl["batch"],
                                  wl["height"], wl["width"], wl["iters"])
        run.counts["conv_ops"] = conv_ops.per_kernel(found)
    return run.counts["conv_ops"]


def traced(run, kernel: str):
    """(launches, device seconds) of ``kernel`` in the traced slice."""
    launches, seconds = 0, 0.0
    for name, (n, s) in run.slice.get("kernels", {}).items():
        m = KERNEL.search(name)
        if m and int(m.group(1)) == conv_ops.STRIDE[kernel]:
            launches += n
            seconds += s
    return launches, seconds


def roofline(run, kernel: str):
    forwards = run.slice.get("requests")
    if not forwards:
        return None
    launches, seconds = traced(run, kernel)
    if not launches or seconds <= 0:
        return None
    want = counted(run).get(kernel)
    if not want or launches != want["launches"] * forwards:
        return None
    return 100.0 * want["bound_s"] * forwards / seconds


def read(run):
    return roofline(run, conv_ops.CONV3X3)
