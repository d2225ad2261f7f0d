#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--seed N]

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (nvcc). Phases, each printing one JSON line:

  1. device    card name, CUDA version, nvidia-smi name and power limit
  2. build     nvcc builds every kernel from bflow_tpu_torch/csrc/
  3. kernel    each kernel against its plain PyTorch version at the
               flagship shapes (f32 and bf16), with times, bound and the
               one-call PyTorch yardstick
  4. forward   the flagship RAFT-Spline inference forward (480x640, B=1,
               bf16, 12 iterations) through build_model(); launch counts
               reset before and read after; ms/forward, fields/s, memory
  5. parity    kernel path vs plain path on the same seeded weights
  6. kernels   one JSON line summing up every kernel
and, as the last line, {"ok": true, "device": {...}}. Any failure exits
nonzero before that line; so does a machine without CUDA. --profile DIR
adds a torch.profiler breakdown of one forward (top kernels by device
time) and writes its chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import bflow_tpu_torch as bt
from bflow_tpu_torch import kernels
from bflow_tpu_torch.kernels import build as kbuild
from bflow_tpu_torch.kernels import corr_lookup as klookup

# flagship B=1 at 480x640: 60x80 queries, and per pyramid level the number
# of targets and the map size (5 targets at level 0, then the 2 deep ones)
H, W = 480, 640
H1, W1 = H // 8, W // 8
LEVELS = [(5, 60, 80), (2, 30, 40), (2, 15, 20), (2, 7, 10)]
RADIUS = 4
ITERS = 12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max |plain|
SPIN_CYCLES = 5_000_000  # ~2.5 ms of device time at H100 clocks


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# timing


_flush_buf = None


def _flush_l2() -> None:
    """Overwrite more than the 50 MB L2, so the next launch reads cold."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = True) -> float:
    """Median device time of fn() in ms, CUDA events around each call.

    A spin kernel runs before each start event, so that the host has
    queued all of fn's launches before the device reaches them: the events
    then time the device work, not the host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            _flush_l2()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: the lookup kernel against its plain version


def level_inputs(Tl: int, hl: int, wl: int, dtype: torch.dtype, seed: int,
                 device="cuda"):
    """A level's (Q, hl, wl) volume and (Q, 2) coords: each query's own
    grid position at this level's scale plus a few pixels of flow, and one
    query in ten far outside the map (+-1e4), as random-init flows are."""
    g = torch.Generator(device=device).manual_seed(seed)
    Q = Tl * H1 * W1
    vol = torch.randn(Q, hl, wl, generator=g, device=device).to(dtype)
    scale = wl / W1
    ii, jj = torch.meshgrid(torch.arange(H1, device=device),
                            torch.arange(W1, device=device), indexing="ij")
    base = torch.stack([jj, ii], dim=-1).float().reshape(1, -1, 2) * scale
    coords = base.expand(Tl, -1, -1).reshape(Q, 2) + 3.0 * torch.randn(
        Q, 2, generator=g, device=device)
    far = torch.rand(Q, generator=g, device=device) < 0.1
    sign = torch.where(torch.rand(Q, 2, generator=g, device=device) < 0.5,
                       -1.0, 1.0)
    coords = torch.where(far[:, None], 1e4 * sign, coords).contiguous()
    return vol, coords


def lookup_bound_bytes(vol: torch.Tensor, coords: torch.Tensor,
                       radius: int) -> int:
    """Bytes the lookup must move for these inputs: per query the part of
    its (2r+2)^2 patch inside the map, its coords, and its outputs."""
    Q, hl, wl = vol.shape
    p = 2 * radius + 2
    lo = torch.floor(coords) - radius  # first patch column / row
    nx = (torch.clamp(lo[:, 0] + p, max=wl) - torch.clamp(lo[:, 0], min=0))
    ny = (torch.clamp(lo[:, 1] + p, max=hl) - torch.clamp(lo[:, 1], min=0))
    patch = (nx.clamp(min=0) * ny.clamp(min=0)).sum().item()
    item = vol.element_size()
    return int(patch * item + Q * 8 + Q * (2 * radius + 1) ** 2 * item)


def grid_sample_call(vol: torch.Tensor, coords: torch.Tensor, radius: int):
    """The one PyTorch call computing the same function (yardstick only):
    grid_sample on (Q, 1, hl, wl) with a normalized (Q, 9, 9, 2) grid."""
    Q, hl, wl = vol.shape
    pts = coords[:, None, :] + klookup.window_offsets(radius, vol.device)
    win = 2 * radius + 1
    grid = torch.stack([2.0 * pts[..., 0] / (wl - 1) - 1.0,
                        2.0 * pts[..., 1] / (hl - 1) - 1.0], dim=-1)
    grid = grid.reshape(Q, win, win, 2).to(vol.dtype)
    inp = vol.reshape(Q, 1, hl, wl)
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def check_lookup_level(Tl, hl, wl, dtype, seed, timing=True):
    """Kernel vs plain at one level shape; returns the phase-3 record."""
    vol, coords = level_inputs(Tl, hl, wl, dtype, seed)
    got = klookup.corr_lookup_level(vol, coords, RADIUS)
    torch.cuda.synchronize()
    want = klookup.corr_lookup_level_plain(vol, coords, RADIUS)
    check(got.dtype == want.dtype == dtype and got.shape == want.shape,
          f"lookup output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    rec = {"Tl": Tl, "hl": hl, "wl": wl, "queries": vol.shape[0],
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "max_abs_ref": ref,
           "tol_rel": TOL[dtype], "ok": err <= TOL[dtype] * ref}
    if not timing:
        return rec
    bound_bytes = lookup_bound_bytes(vol, coords, RADIUS)
    rec.update(
        ms=time_ms(lambda: klookup.corr_lookup_level(vol, coords, RADIUS)),
        warm_ms=time_ms(
            lambda: klookup.corr_lookup_level(vol, coords, RADIUS),
            cold=False),
        plain_ms=time_ms(
            lambda: klookup.corr_lookup_level_plain(vol, coords, RADIUS)),
        bound_bytes=bound_bytes,
        bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
    )
    try:
        lib = grid_sample_call(vol, coords, RADIUS)
        lib()
        rec["library_dtype"] = rec["dtype"]
    except RuntimeError as exc:  # a yardstick only: time it in f32
        rec["library_note"] = f"grid_sample refused {dtype}: {exc}"[:200]
        lib = grid_sample_call(vol.float(), coords, RADIUS)
        rec["library_dtype"] = "float32"
    rec["library_ms"] = time_ms(lib)
    return rec


# ---------------------------------------------------------------------------
# phases 4 and 5: the model


def flagship_inputs(seed: int, device="cuda"):
    cfg = bt.flagship_config()
    rng = np.random.default_rng(seed)
    voxel = rng.standard_normal((1, H, W, cfg.nbins_total)).astype(
        np.float32)
    images = rng.integers(0, 255, (2, 1, H, W, 3)).astype(np.float32)
    return (torch.from_numpy(voxel).to(device),
            torch.from_numpy(images).to(device))


def run_forward(model, voxel, images, iters=None):
    low, up = model(voxel, images, iters=iters, test_mode=True)
    torch.cuda.synchronize()
    return low, up


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()


def damped_pair(cfg, seed):
    """The same seeded weights, Bezier head damped x0.02 (a trained-like
    contractive recurrence), as a kernel-path and a plain-path model."""
    kern = bt.build_model(dataclasses.replace(cfg, lookup_method="pallas"),
                          "cuda", seed)
    with torch.no_grad():
        kern.update_block.bezier_head.conv2.weight.mul_(0.02)
    plain = bt.build_model(dataclasses.replace(cfg, lookup_method="gather"),
                           "cuda", seed)
    plain.load_state_dict(kern.state_dict())
    return kern, plain


def profile_forward(model, voxel, images, unprofiled_ms: float,
                    out_dir: str) -> None:
    """Kernel time by name over one forward; the idle share is 1 - the
    summed kernel time over the unprofiled forward time."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    run_forward(model, voxel, images)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_forward(model, voxel, images)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "forward_trace.json"))
    # device kernels only (the aten ops above them carry the same time)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    kernel_ms = sum(r[0] for r in rows) / 1e3
    lookup = [r for r in rows if "corr_lookup_fwd" in r[1]]
    emit("profile", profiled_wall_ms=wall_ms, kernel_ms=kernel_ms,
         device_calls=sum(r[2] for r in rows), unprofiled_ms=unprofiled_ms,
         device_idle_share=max(0.0, 1 - kernel_ms / unprofiled_ms),
         lookup_kernel_ms=sum(r[0] for r in lookup) / 1e3,
         lookup_kernel_calls=sum(r[2] for r in lookup),
         top=[{"name": k[:100], "device_ms": us / 1e3, "calls": n}
              for us, k, n in rows[:25]])


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one forward, write its trace into DIR")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, cuda=torch.version.cuda,
         torch=torch.__version__, count=torch.cuda.device_count(),
         nvidia_smi=smi)
    print(smi, flush=True)  # the card's name and power limit, as is

    # 2. build
    t0 = time.perf_counter()
    report = kbuild.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "ptxas": v["ptxas"][-600:]}
                  for k, v in report.items()})

    # 3. kernel vs plain at the flagship level shapes
    per_level = []
    for dtype in (torch.float32, torch.bfloat16):
        for lvl, (Tl, hl, wl) in enumerate(LEVELS):
            rec = check_lookup_level(Tl, hl, wl, dtype, args.seed + lvl)
            rec["level"] = lvl
            emit("kernel", name=klookup.NAME, **rec)
            check(rec["ok"], f"lookup kernel disagrees: {rec}")
            per_level.append(rec)

    # 4. the flagship forward through the kernel
    cfg = bt.flagship_config()
    model = bt.build_model(cfg, device="cuda", seed=args.seed)
    voxel, images = flagship_inputs(args.seed)
    warmup, timed = 2, 5
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(warmup):
        low, up = run_forward(model, voxel, images)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        low, up = run_forward(model, voxel, images)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    flow = up.flow_at(1.0)
    n_fwd = warmup + timed
    per_fwd = {k: v / n_fwd for k, v in counts.items()}
    ms = statistics.median(times)
    emit("forward", config="flagship E_I_LU4_BD2 bf16 fuse_corr_conv",
         batch=1, height=H, width=W, iters=ITERS, forwards=n_fwd,
         ms_per_forward=ms, ms_all=times, fields_per_s=1e3 / ms,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, launches_per_forward=per_fwd,
         flow_shape=list(flow.shape),
         finite=bool(torch.isfinite(up.params).all()))
    check(tuple(flow.shape) == (1, H, W, 2), f"flow shape {flow.shape}")
    check(bool(torch.isfinite(up.params).all())
          and bool(torch.isfinite(low.params).all()), "non-finite output")
    want = len(LEVELS) * ITERS
    check(per_fwd[klookup.NAME] == want,
          f"{klookup.NAME}: {per_fwd[klookup.NAME]} launches per forward, "
          f"want {want}")
    if args.profile:
        profile_forward(model, voxel, images, ms, args.profile)
    del model

    # 5. kernel path vs plain path on the card
    for precision, iters, bound in (("bfloat16", ITERS, 5e-2),
                                    ("float32", 2, 1e-4)):
        c = dataclasses.replace(cfg, corr_precision=precision,
                                compute_dtype=precision)
        kern, plain = damped_pair(c, args.seed)
        _, up_k = run_forward(kern, voxel, images, iters)
        _, up_p = run_forward(plain, voxel, images, iters)
        rel = {t: rel_diff(up_k.flow_at(t), up_p.flow_at(t))
               for t in (0.5, 1.0)}
        emit("parity", precision=precision, iters=iters, bound=bound,
             rel_diff={str(t): v for t, v in rel.items()})
        check(all(v < bound for v in rel.values()),
              f"kernel path vs plain path {precision}: {rel}")
        del kern, plain

    # 6. kernels line: one lookup launch per level, so the per-iteration
    # cost is the sum over the four bf16 level records
    bf16 = [r for r in per_level if r["dtype"] == "bfloat16"]
    summary = [{
        "name": klookup.NAME,
        "route": "cuda",
        "source": "bflow_tpu_torch/csrc/corr_lookup_fwd.cu",
        "replaces": "bflow_tpu/ops/pallas/corr_lookup_v3.py:238",
        "launches": counts[klookup.NAME],
        "max_abs_err": max(r["max_abs_err"] for r in per_level),
        "ms": sum(r["ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
        "bound_ms": sum(r["bound_ms"] for r in bf16),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in bf16),
    }]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
