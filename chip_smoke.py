#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bflow_tpu_torch) on one NVIDIA GPU: its
checks on the card, and the times of its hand-written kernels. The rates
the benchmark's cells measure (fields/s, samples/s) and the device's idle
share come from benchmark/run.py, not from here.

    python3 chip_smoke.py [--seed N] [--conv-sweep] [--conv-loops]
                          [--lookup-probe] [--eval-only] [--train-only]
                          [--dist-only] [--stream-only]

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (nvcc). Phases, each printing JSON lines:

  1. device       card name, CUDA version, nvidia-smi name and power limit
  2. build        nvcc builds every kernel from bflow_tpu_torch/csrc/
  3. kernel       each kernel against its plain PyTorch version, with
                  times, bound and the one-call PyTorch yardstick: the
                  all-level lookup forward (one launch for the four
                  flagship levels, f32 and bf16, exact, and each level
                  against the one-level entry); (3b) its backward, 12
                  iterations accumulated into one f32 dVol buffer per
                  level at the flagship (bf16) and DSEC training (f32)
                  shapes, twice, bitwise equal, and the one-level entries;
                  (3c) the same forward over pallas_q8's tables (int8
                  levels 0-1 beside bf16 levels 2-3 in one launch, and the
                  int8 levels alone; bit-equal, each int8 level against
                  the one-level int8 entry), and the stem and conv3x3 kernels
                  at every flagship shape their gates pass, on
                  channels-last and NCHW-contiguous inputs, with the
                  wrapper's layout copies and prepared weights counted and
                  gradients through their autograd.Functions included;
                  (conv_loops) the conv3x3 kernel's two main loops forced
                  at every conv3x3 shape of the flagship forward at B=1
                  and of the bf16 DSEC cell's at B=16: bit-equal, each
                  within TOL of the plain version, each timed beside the
                  bound, the loop launch_plan takes named
                  and the forward's totals summed (conv_loops_summary);
                  (3d) the norm kernel (instance norm and eval BatchNorm,
                  ReLU fused) at the bf16 DSEC cell's encoder shapes at
                  B=16, channels-last, timed beside its byte bound, its
                  plain version and F.instance_norm / F.batch_norm, and
                  on NCHW inputs; within one bf16 ulp, bit-repeatable,
                  the input's layout kept; then its f32 instantiation
                  at every encoder norm shape of the f32 eval cells
                  against the eager f32 chain (within a few ulp of the
                  largest output), timed at DSEC fnet_ev's stage 1 (N=40)
                  beside its byte bounds and the eager chain, NCHW and
                  channels-last, ReLU and residual; (3e) the convc1
                  kernel at the map widths of DSEC E_I, MultiFlow E_I and
                  DSEC events-only (891, 972, 567 channels) and M = 76,800,
                  4,800, 1,280 and 1,000 rows, held to the exact result of
                  its function (within one bf16 ulp, or the f32 sums'
                  round-off near 0), bit-repeatable, and timed at DSEC
                  E_I's width beside its byte bound, its plain version,
                  the f32 torch.addmm and a bf16 torch.mm
  4. forward      the flagship RAFT-Spline inference forward (480x640, B=1,
                  bf16, 12 iterations) through build_model(), twice; launch
                  counts reset before and read after (one all-level lookup
                  launch per iteration); memory, finite flows;
                  (4b, opt_forward) the same with pallas_q8, pallas_stem and
                  pallas_conv, launches held to the count the copied gates
                  give (one all-level lookup launch per iteration, int8
                  levels included), in the second forward layout copies to
                  one per conv whose channel count is not a multiple of 8
                  and no weight prepared again
  5. parity       kernel path vs plain path on the same seeded weights;
                  (5b, opt_parity) the opt-in path vs its plain twins, and
                  vs the default path (recorded)
  6. train        the DSEC training step (f32, 12 iterations, B=3 at
                  288x384, AdamW + OneCycle) through make_train_step: 7
                  steps on one batch (the loss must fall), launches per step
                  (12 lookup forward, 12 backward), loss per step, memory;
                  one more step under torch.profiler (one dVol zeroing per
                  level, no dVol sum); then one bf16 flagship step, and
                  (6c, train_conv) one with the stem and conv kernels, its
                  gradients vs the plain twins'
     train_parity kernel path vs gather path, loss and gradients of a step
  7. eval         the DSEC evaluation path through the port's own entry
                  points, on fabricated recordings in the DSEC directory
                  contract at 480x640 (~10^6 events per window; 9 train
                  and 4 test windows) in a temporary directory:
                  (7a, eval_data) writing them; (7b, eval_voxelize) one
                  window's rectified and raw events through the device
                  voxelizer vs the host rasterizer (<= 1e-4), host and
                  device ms; (7c, eval_val) bflow_tpu_torch.val.main with
                  the flagship experiment overrides at batch 4 (two
                  batches and a tail of 1) on a damped-head port
                  checkpoint: uncached, writing the voxel caches, reading
                  them (equal metrics), the composed config ==
                  flagship_config(), 12 lookup launches per forward, the
                  CSV's val/* within 5e-2 of make_eval_step on the plain
                  twins, the loader-wait share; (7d,
                  eval_val_opt_in) the opt-in modes in one batch, launches
                  12 / 9 / 138 per forward; (7e, eval_predict)
                  predict_dsec on the test recording: 4 PNGs within 1/128
                  px of the eval forward
  9. train_cli    MultiFlow training through the port's own training CLI
                  (bflow_tpu_torch.train.loop.main), E_I_LU5_BD10 at full
                  width (41/25 bins, degree 10, 12 iterations, f32, B=3
                  at 368x496), on fabricated 384x512 samples (6 train, 3
                  val, ~10^6 events each) in a temporary directory:
                  (train_cli_data) writing them; (train_cli) two epochs
                  of two steps from a damped-head port checkpoint, logs
                  and media every step, validation each epoch, best and
                  last checkpoints, launch counts derived (12 + 12 per
                  step, 12 per media or val forward), learning rates
                  against a fresh OneCycle; (train_cli_resume) the rerun
                  in the same run directory continues at step 4 to step
                  6; (train_cli_plain) step 1 on the plain twins, loss
                  within 1e-5; the two lookups at these shapes, degree-10
                  flow_at against de Casteljau, one more step under
                  torch.profiler (12 + 12 lookup launches, one dVol zeroing
                  per level, no dVol sum) (phase 9 runs after 7; the
                  kernels line is printed last)
 10. dist         data-parallel training (bflow_tpu_torch.parallel):
                  (10a, dist_world1) phase 6's step over an NCCL group of
                  one rank (DDP, the global BatchNorm, the loss's global
                  count, the packed metrics) against no group; (10b,
                  dist_two_ranks) two ranks on the one card over gloo,
                  global batch 6 (3 + 3, valid shares 30% and 90%) against
                  one process at batch 6: loss, metric accumulators (rel
                  1e-5), gradients after the reduction (1e-4 of the
                  largest), cnet's running statistics (rel 1e-5), 12 + 12
                  lookup launches per rank, each rank's step ms, a
                  gradient-sized all-reduce's ms and peak memory; (10c)
                  the training CLI on phase 9's samples: under torchrun
                  (one NCCL rank, 2 steps), hardware.loader=grain against
                  threaded (step 1 equal), and hardware.devices=2 on
                  cuda:0 over gloo (one CSV, rank 0's checkpoints, step-1
                  loss within 1e-5 of one rank)
 11. stream       streaming inference over raw events and the released-
                  checkpoint tool: (11a, stream_window) one window at full
                  width (bflow_tpu_torch.streaming: 300,000 events padded
                  to 2^19, 256x320, 5 + 5 bins, 6 iterations, bf16, flows
                  at 4 query times): the device grid against the host
                  VoxelGrid (1e-4), the flows (Bezier head damped)
                  against the plain twins (5e-2), then streaming.main (a
                  first window and 8 more) with its lookup launches held
                  to 6 per window and its peak memory;
                  (11b, released_family) each of the four released
                  families (bflow_tpu_torch.parity_released): its
                  random-init export saved as a .ckpt, read back and its
                  architecture inferred, then the tool at the native size
                  (DSEC 480x640, MultiFlow 384x512; B=1, 12 iterations,
                  f32, --bf16-also --q8-also) with both TF32 flags on in
                  the caller and on again after it, 12 lookup launches per
                  forward, the f32 flows against the plain twins (1e-3);
                  (11c) the all-level lookup at the events-only and
                  streaming tables, exact against its twin, timed with its
                  bound and F.grid_sample, and its int8 instantiation at
                  the streaming table
 12. f32_eval     evaluation at the config's own precision (f32), with
                  both TF32 flags on in the caller (PyTorch's cuDNN
                  default), on phase 7's recordings and phase 9's samples:
                  (12a, f32_val) bflow_tpu_torch.val.main with the
                  flagship experiment and no model.precision.* override
                  at batch 4, the composed config == flagship_config() at
                  f32, 12 lookup launches per forward, the CSV's val/*
                  within 1e-4 relative of make_eval_step on the plain
                  twins with TF32 off, the flags left on; (12b) the same
                  on MultiFlow's val split, E_I_LU5_BD10 at full width
                  (41/25 bins, degree 10, 384x512) at batch 2; (12c,
                  f32_predict) predict_dsec: 4 PNGs within 1/128 px of
                  the f32 eval forward, and that forward within 1e-4 of
                  the plain twins' (TF32 off); (12d, f32_pin) the f32
                  flagship forward and phase 6's train step with TF32 on
                  and off, bit-equal under deterministic cuDNN; (12e) the
                  all-level lookup at the two f32 val tables, exact
  8. kernels      one JSON line summing up every kernel
and, as the last line, {"ok": true, "device": {...}}. Any failure exits
nonzero before that line; so does a machine without CUDA.
--eval-only runs phases 1, 2, 7 and 12 and stops; --train-only runs phases
1, 2 and 9 and stops; --dist-only runs phases 1, 2 and 10 and stops;
--stream-only runs phases 1, 2 and 11 and stops.
--conv-sweep runs phases 1 and 2, then times every tile variant of the conv
kernels at every flagship conv shape beside the one the tile plan picks,
and stops. --lookup-probe runs phases 1 and 2, then times the all-level
lookup kernels' probe variants (patch loads, stores, accumulator read or
cotangents taken out) at the flagship shapes, the forward's also over
pallas_q8's tables, and stops.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Bytecode: where Python runs with PYTHONDONTWRITEBYTECODE (the card's
# machine does), every process compiles torch's modules anew, ~8 s a
# process. This process writes their bytecode into the gitignored build
# directory before it imports them, and the processes it starts (ranks,
# loader workers, torchrun) read it from there.
_PYCACHE = Path(__file__).resolve().parent / "bflow_tpu_torch" / "build"
if _PYCACHE.parent.is_dir():
    sys.pycache_prefix = str(_PYCACHE / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# W&B stays off the network: the port's logger is a no-op under wandb's
# own switch (wandb may be installed where there is no network)
os.environ["WANDB_MODE"] = "disabled"

import bflow_tpu_torch as bt  # noqa: E402
from bflow_tpu_torch import kernels
from bflow_tpu_torch.kernels import build as kbuild
from bflow_tpu_torch.kernels import conv3x3 as kconv
from bflow_tpu_torch.kernels import conv_common
from bflow_tpu_torch.kernels import corr_lookup as klookup
from bflow_tpu_torch.kernels import corr_proj as kproj
from bflow_tpu_torch.kernels import norm as knorm
from bflow_tpu_torch.kernels import stem_conv as kstem
from bflow_tpu_torch.models.corr import KERNEL_METHODS, quantizes

# flagship B=1 at 480x640: 60x80 queries, and per pyramid level the number
# of targets and the map size (5 targets at level 0, then the 2 deep ones)
H, W = 480, 640
H1, W1 = H // 8, W // 8
LEVELS = [(5, 60, 80), (2, 30, 40), (2, 15, 20), (2, 7, 10)]
RADIUS = 4
ITERS = 12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# the DSEC training step: global batch 3 at the 288x384 training crop
TRAIN_B, TRAIN_H, TRAIN_W = 3, 288, 384
TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
            "gradient_clip_val": 1,
            "lr_scheduler": {"use": True, "total_steps": 250000,
                             "pct_start": 0.01}}
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max |plain|
# backward, (dvol, dcoords), of max |plain|: dcoords sums 81 taps in
# another order than autograd does
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
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


def patch_cells(vol: torch.Tensor, coords: torch.Tensor, radius: int) -> int:
    """The cells of every query's (2r+2)^2 patch that lie inside its map:
    (Q, hl, wl) maps, (Q, 2) coords at the maps' scale."""
    _, hl, wl = vol.shape
    p = 2 * radius + 2
    lo = torch.floor(coords) - radius  # first patch column / row
    nx = (torch.clamp(lo[:, 0] + p, max=wl) - torch.clamp(lo[:, 0], min=0))
    ny = (torch.clamp(lo[:, 1] + p, max=hl) - torch.clamp(lo[:, 1], min=0))
    return int((nx.clamp(min=0) * ny.clamp(min=0)).sum().item())


def _table_coord_bytes(table, coords) -> int:
    """The base coords the all-level kernels read: 8 bytes per query
    position of every target the table names, once however many of its
    levels name it."""
    return len({t for lv in table for t in lv.targets}) * coords[0].numel() * 4


def pyramid_bound_bytes(table, coords, radius: int) -> int:
    """Bytes the all-level lookup must move for these inputs: per (level,
    target) slot its queries' in-map patch cells in the level's type (one
    byte for int8) and their outputs in the output type, an int8 level's
    f32 row scales once each, and the base coords once per target."""
    taps = (2 * radius + 1) ** 2
    out_item = torch.empty(0, dtype=klookup._out_dtype(table)).element_size()
    total = 0
    for lv in table:
        total += (patch_cells(*level_views(lv, coords), radius)
                  * lv.vol.element_size()
                  + lv.vol.shape[:4].numel() * taps * out_item)
        if lv.scale is not None:
            total += lv.scale.numel() * 4
    return total + _table_coord_bytes(table, coords)


def _sample_grid(vol: torch.Tensor, coords: torch.Tensor, radius: int):
    """grid_sample's (Q, 1, hl, wl) input view and normalized
    (Q, 2r+1, 2r+1, 2) grid for the lookup's taps (yardsticks only)."""
    Q, hl, wl = vol.shape
    pts = coords[:, None, :] + klookup.window_offsets(radius, vol.device)
    win = 2 * radius + 1
    grid = torch.stack([2.0 * pts[..., 0] / (wl - 1) - 1.0,
                        2.0 * pts[..., 1] / (hl - 1) - 1.0], dim=-1)
    return vol.reshape(Q, 1, hl, wl), grid.reshape(Q, win, win, 2).to(
        vol.dtype)


def grid_sample_call(vol: torch.Tensor, coords: torch.Tensor, radius: int):
    """The one PyTorch call computing the same function (yardstick only):
    grid_sample on (Q, 1, hl, wl) with a normalized (Q, 9, 9, 2) grid."""
    inp, grid = _sample_grid(vol, coords, radius)
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def check_lookup_level(Tl, hl, wl, dtype, seed):
    """The one-level entry (the forward kernel with a one-level table) vs
    its plain version at one level shape; returns the record."""
    vol, coords = level_inputs(Tl, hl, wl, dtype, seed)
    got = klookup.corr_lookup_level(vol, coords, RADIUS)
    torch.cuda.synchronize()
    want = klookup.corr_lookup_level_plain(vol, coords, RADIUS)
    check(got.dtype == want.dtype == dtype and got.shape == want.shape,
          f"lookup output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    return {"Tl": Tl, "hl": hl, "wl": wl, "queries": vol.shape[0],
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "max_abs_ref": ref, "ok": err == 0.0}


def pyramid_bwd_bound_bytes(table, coords, radius: int) -> int:
    """Bytes the all-level lookup's VJP must move for these inputs: per
    (level, target) slot its queries' cotangents, the in-map cells of their
    (2r+2)^2 patches read from vol, and those cells of the f32 dVol
    accumulator read and written (4 + 4 bytes each: the backward adds into
    it); the base coords read once per target the table names, and dcoords
    written once per base target."""
    taps = (2 * radius + 1) ** 2
    item = table[0].vol.element_size()
    slots = sum(patch_cells(*level_views(lv, coords), radius) * (item + 8)
                + lv.vol.shape[:4].numel() * taps * item for lv in table)
    return slots + _table_coord_bytes(table, coords) + coords.numel() * 4


def grid_sample_vjp_call(vol: torch.Tensor, coords: torch.Tensor,
                         g: torch.Tensor, radius: int):
    """The one PyTorch call computing the same VJP (yardstick only):
    torch.autograd.grad of grid_sample on (input, grid), graph built
    once; its backward zero-fills the input gradient itself."""
    inp, grid = _sample_grid(vol.detach(), coords, radius)
    inp, grid = inp.requires_grad_(True), grid.requires_grad_(True)
    out = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    gout = g.reshape(out.shape).to(out.dtype)
    return lambda: torch.autograd.grad(out, (inp, grid), gout,
                                       retain_graph=True)


def check_lookup_bwd_level(Tl, hl, wl, dtype, seed):
    """The one-level backward entry (zeroed dvol, then the kernel with a
    one-level table) vs its plain twin at one level shape, two calls
    bitwise equal; returns the record."""
    vol, coords = level_inputs(Tl, hl, wl, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    Q = vol.shape[0]
    g = torch.randn(Q, (2 * RADIUS + 1) ** 2, generator=gen,
                    device="cuda").to(dtype)
    dv, dc = klookup.lookup_bwd_cuda(vol, coords, g, RADIUS)
    dv2, dc2 = klookup.lookup_bwd_cuda(vol, coords, g, RADIUS)
    torch.cuda.synchronize()
    want_v, want_c = klookup.corr_lookup_level_bwd_plain(vol, coords, g,
                                                         RADIUS)
    check(dv.dtype == want_v.dtype == dtype and dc.dtype == torch.float32,
          f"lookup bwd types {dv.dtype} {dc.dtype}")
    tol_v, tol_c = BWD_TOL[dtype]
    err_v = (dv.float() - want_v.float()).abs().max().item()
    ref_v = want_v.float().abs().max().item()
    err_c = (dc - want_c).abs().max().item()
    ref_c = want_c.abs().max().item()
    repeat = bool(torch.equal(dv, dv2) and torch.equal(dc, dc2))
    return {"Tl": Tl, "hl": hl, "wl": wl, "queries": Q,
            "dtype": str(dtype).replace("torch.", ""),
            "dvol_max_abs_err": err_v, "dvol_max_abs_ref": ref_v,
            "dcoords_max_abs_err": err_c, "dcoords_max_abs_ref": ref_c,
            "tol_rel": [tol_v, tol_c], "bitwise_repeatable": repeat,
            "ok": (err_v <= tol_v * ref_v and err_c <= tol_c * ref_c
                   and repeat)}


# the all-level lookup: the flagship pyramid's targets per level
PYRAMID_TARGETS = [(0, 1, 2, 3, 4), (3, 4), (3, 4), (3, 4)]


def pyramid_inputs(n, h1, w1, dtype, seed, device="cuda",
                   targets=PYRAMID_TARGETS):
    """A level table (`targets` per level, the flagship's by default;
    (n, h1, w1) queries, maps h1 x w1 halved per level) and base coords
    (T, n, h1, w1, 2), T base targets: each query's own grid position
    plus a few pixels of flow, one in
    ten far outside the map (+-1e4), one in ten just below a multiple of
    8 (just below an integer at every level: the kernels' rounding
    edge)."""
    g = torch.Generator(device=device).manual_seed(seed)
    T = 1 + max(max(idx) for idx in targets)
    table = []
    for lvl, idx in enumerate(targets):
        vol = torch.randn(len(idx), n, h1, w1, h1 >> lvl, w1 >> lvl,
                          generator=g, device=device).to(dtype)
        table.append(klookup.TableLevel(vol, idx, lvl))
    ii, jj = torch.meshgrid(torch.arange(h1, device=device),
                            torch.arange(w1, device=device), indexing="ij")
    base = torch.stack([jj, ii], dim=-1).float().expand(T, n, h1, w1, 2)
    c = base + 3.0 * torch.randn(T, n, h1, w1, 2, generator=g, device=device)
    far = torch.rand(T, n, h1, w1, 1, generator=g, device=device) < 0.1
    sign = torch.where(torch.rand(T, n, h1, w1, 2, generator=g,
                                  device=device) < 0.5, -1.0, 1.0)
    c = torch.where(far, 1e4 * sign, c)
    edge = torch.rand(T, n, h1, w1, 1, generator=g, device=device) < 0.1
    below = torch.nextafter(torch.round(c / 8) * 8,
                            torch.full_like(c, -float("inf")))
    return table, torch.where(edge, below, c).contiguous()


def level_views(lv, coords):
    """A table level as the one-level entries take it: (Q, hl, wl) maps,
    (Q, 2) coords at the level's scale."""
    return klookup._level_maps(lv), klookup._level_coords(coords, lv)


def _table_record(table, coords, timing):
    """The all-level forward over one table vs its plain twin (exact) and
    each level's channels vs its one-level entry (corr_lookup_level_q8
    for int8 levels); with timing, its time, plain time and bound."""
    got = klookup.lookup_pyramid_cuda(table, coords, RADIUS)
    torch.cuda.synchronize()
    want = klookup.corr_lookup_pyramid_plain(table, coords, RADIUS)
    check(got.dtype == want.dtype == klookup._out_dtype(table)
          and got.shape == want.shape,
          f"table lookup output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    n, h1, w1 = coords.shape[1:4]
    per_level, s = True, 0
    for lv in table:
        tl = len(lv.targets)
        vol, c = level_views(lv, coords)
        one = (klookup.corr_lookup_level_q8(vol, lv.scale, c, RADIUS)
               if lv.scale is not None
               else klookup.corr_lookup_level(vol, c, RADIUS))
        mine = got.reshape(n, h1, w1, -1, 81)[..., s:s + tl, :]
        per_level &= bool(torch.equal(
            one.to(got.dtype), mine.permute(3, 0, 1, 2, 4).reshape(-1, 81)))
        s += tl
    rec = {"levels": [[lv.level, str(lv.vol.dtype).replace("torch.", "")]
                      for lv in table],
           "queries": [n, h1, w1],
           "items": sum(lv.vol.shape[:4].numel() for lv in table),
           "dtype": str(got.dtype).replace("torch.", ""), "max_abs_err": err,
           "max_abs_ref": want.float().abs().max().item(),
           "per_level_equal": per_level, "ok": err == 0.0 and per_level}
    if timing:
        bound_bytes = pyramid_bound_bytes(table, coords, RADIUS)
        rec.update(
            ms=time_ms(lambda: klookup.lookup_pyramid_cuda(table, coords,
                                                           RADIUS)),
            plain_ms=time_ms(lambda: klookup.corr_lookup_pyramid_plain(
                table, coords, RADIUS)),
            bound_bytes=bound_bytes,
            bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
            library_ms=None,
            library_note="no single PyTorch call samples an int8 volume "
                         "with per-row scales (grid_sample takes float "
                         "types only)")
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    return rec


def check_lookup_pyramid(n, h1, w1, dtype, seed, timing=True,
                         targets=PYRAMID_TARGETS):
    """The all-level forward kernel (one launch) vs its plain twin, exact;
    each level's channels vs the one-level entry; returns the phase-3
    record with the time per iteration, the bound summed over levels and
    grid_sample summed over levels."""
    table, coords = pyramid_inputs(n, h1, w1, dtype, seed, targets=targets)
    rec = _table_record(table, coords, timing=False)
    if not timing:
        return rec
    bound_bytes = pyramid_bound_bytes(table, coords, RADIUS)
    rec.update(
        ms=time_ms(lambda: klookup.lookup_pyramid_cuda(table, coords,
                                                       RADIUS)),
        warm_ms=time_ms(lambda: klookup.lookup_pyramid_cuda(
            table, coords, RADIUS), cold=False),
        # where the time goes: level 0 (24,000 items at the flagship)
        # alone, and levels 1-3 alone
        level0_ms=time_ms(lambda: klookup.lookup_pyramid_cuda(
            table[:1], coords, RADIUS)),
        levels123_ms=time_ms(lambda: klookup.lookup_pyramid_cuda(
            table[1:], coords, RADIUS)),
        plain_ms=time_ms(lambda: klookup.corr_lookup_pyramid_plain(
            table, coords, RADIUS)),
        bound_bytes=bound_bytes,
        bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3)
    calls, rec["library_dtype"] = [], rec["dtype"]
    for lv in table:
        vol, c = level_views(lv, coords)
        try:
            call = grid_sample_call(vol, c, RADIUS)
            call()
        except RuntimeError as exc:  # a yardstick only: time it in f32
            rec["library_note"] = f"grid_sample refused {dtype}: {exc}"[:200]
            rec["library_dtype"] = "float32"
            call = grid_sample_call(vol.float(), c, RADIUS)
        calls.append(call)
    rec["library_ms"] = time_ms(lambda: [call() for call in calls])
    rec["library_what"] = "F.grid_sample once per level, summed"
    return rec


def check_lookup_pyramid_bwd(n, h1, w1, dtype, seed, iters=ITERS,
                             timing=True, targets=PYRAMID_TARGETS):
    """The all-level backward kernel: `iters` iterations' cotangents, last
    iteration first, accumulated into one f32 dVol buffer per level, twice
    (bitwise equal), against the accumulating plain twin and against the
    sum of the per-level corr_lookup_level_bwd_plain calls (twin and sum
    equal exactly); dcoords of every iteration against the twin's. Returns
    the phase-3b record with the time per iteration, the one zeroing per
    step, the bound and the grid_sample VJP summed over levels."""
    table, coords = pyramid_inputs(n, h1, w1, dtype, seed, targets=targets)
    C = sum(len(lv.targets) for lv in table) * 81
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    gs = [torch.randn(n, h1, w1, C, generator=gen, device="cuda").to(dtype)
          for _ in range(iters)]

    def zeros():
        return [torch.zeros(lv.vol.shape, device="cuda") for lv in table]

    runs = []
    for _ in range(2):
        acc = zeros()
        dcs = [klookup.lookup_pyramid_bwd_cuda(table, coords, g, RADIUS, acc)
               for g in reversed(gs)]
        runs.append((acc, dcs))
    torch.cuda.synchronize()
    (acc, dcs), (acc2, dcs2) = runs
    repeat = all(torch.equal(a, b) for a, b in zip(acc + dcs, acc2 + dcs2))
    twin = zeros()
    dcs_p = [klookup.corr_lookup_pyramid_bwd_plain(table, coords, g, RADIUS,
                                                   twin)
             for g in reversed(gs)]
    # the twin is the per-level VJPs, rounded to the volume's type and
    # summed in f32 in backward order
    twin_is_sum, off = True, 0
    for i, lv in enumerate(table):
        tl = len(lv.targets)
        vol, c = level_views(lv, coords)
        total = torch.zeros(lv.vol.shape, device="cuda")
        for g in reversed(gs):
            gl = g[..., off:off + tl * 81].reshape(n, h1, w1, tl, 81)
            dv, _ = klookup.corr_lookup_level_bwd_plain(
                vol, c, gl.permute(3, 0, 1, 2, 4).reshape(-1, 81), RADIUS)
            total += dv.reshape(lv.vol.shape).float()
        twin_is_sum &= bool(torch.equal(total, twin[i]))
        off += tl * 81
    tol_v, tol_c = BWD_TOL[dtype]
    err_v = max((a - b).abs().max().item() for a, b in zip(acc, twin))
    ref_v = max(b.abs().max().item() for b in twin)
    err_c = max((a - b).abs().max().item() for a, b in zip(dcs, dcs_p))
    ref_c = max(b.abs().max().item() for b in dcs_p)
    rec = {"queries": [n, h1, w1], "iters": iters,
           "dtype": str(dtype).replace("torch.", ""),
           "dvol_max_abs_err": err_v, "dvol_max_abs_ref": ref_v,
           "dcoords_max_abs_err": err_c, "dcoords_max_abs_ref": ref_c,
           "tol_rel": [tol_v, tol_c], "bitwise_repeatable": repeat,
           "twin_equals_sum_of_level_vjps": twin_is_sum,
           "ok": (err_v <= tol_v * ref_v and err_c <= tol_c * ref_c
                  and repeat and twin_is_sum)}
    if not timing:
        return rec
    bound_bytes = pyramid_bwd_bound_bytes(table, coords, RADIUS)
    g0 = gs[0]
    rec.update(
        ms=time_ms(lambda: klookup.lookup_pyramid_bwd_cuda(
            table, coords, g0, RADIUS, acc)),
        # where the time goes: dVol alone, dcoords alone
        dvol_only_ms=time_ms(lambda: klookup.lookup_pyramid_bwd_cuda(
            table, coords, g0, RADIUS, acc, False)),
        dcoords_only_ms=time_ms(lambda: klookup.lookup_pyramid_bwd_cuda(
            table, coords, g0, RADIUS, None)),
        zero_ms_per_step=time_ms(zeros),
        plain_ms=time_ms(lambda: klookup.corr_lookup_pyramid_bwd_plain(
            table, coords, g0, RADIUS, twin), reps=5),
        bound_bytes=bound_bytes,
        bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3)
    calls, rec["library_dtype"], off = [], rec["dtype"], 0
    for lv in table:
        tl = len(lv.targets)
        vol, c = level_views(lv, coords)
        gl = g0[..., off:off + tl * 81].reshape(n, h1, w1, tl, 81).permute(
            3, 0, 1, 2, 4).reshape(-1, 81)
        off += tl * 81
        try:
            call = grid_sample_vjp_call(vol, c, gl, RADIUS)
            call()
        except RuntimeError as exc:  # a yardstick only: time it in f32
            rec["library_note"] = (f"grid_sample VJP refused {dtype}: "
                                   f"{exc}")[:200]
            rec["library_dtype"] = "float32"
            call = grid_sample_vjp_call(vol.float(), c, gl.float(), RADIUS)
        calls.append(call)
    rec["library_ms"] = time_ms(lambda: [call() for call in calls])
    rec["library_what"] = ("the grid_sample VJP once per level, summed "
                           "(each zero-fills its own input gradient)")
    return rec


# csrc/corr_lookup_table.cuh: Probe
PROBE_NO_PATCH, PROBE_NO_STORE, PROBE_NO_ACC_READ, PROBE_NO_COTANGENT = (
    1, 2, 4, 8)
FWD_PROBES = {"kernel": 0, "no_patch": PROBE_NO_PATCH,
              "no_store": PROBE_NO_STORE,
              "no_patch_no_store": PROBE_NO_PATCH | PROBE_NO_STORE}
BWD_PROBES = {"kernel": 0, "no_patch": PROBE_NO_PATCH,
              "no_acc_read": PROBE_NO_ACC_READ,
              "no_cotangent": PROBE_NO_COTANGENT,
              "no_loads": (PROBE_NO_PATCH | PROBE_NO_ACC_READ
                           | PROBE_NO_COTANGENT)}


def lookup_probe(seed: int) -> None:
    """Where the all-level lookups' time goes: their bf16 r = 4 probe
    variants (the kernel's code with the volume patch's loads, the stores,
    the accumulator's read or the cotangents' loads taken out; their
    results are wrong by design and not read) at the flagship shapes, L2
    flushed before each launch, beside the kernel through its wrapper; the
    forward's over the default table (bf16 levels 0-3) and over
    pallas_q8's tables (int8 levels 0-1 beside bf16 levels 2-3, and the
    int8 levels alone: the kernel's int8 instantiation). Each probe's time
    is printed with its difference from the whole kernel's (probe 0, the
    same code)."""
    ptr = ctypes.POINTER(klookup._LookupTable)
    vp = ctypes.c_void_p
    fwd = kbuild.function(klookup.NAME, "corr_lookup_fwd_probe_bf16",
                          [ptr, vp, vp, ctypes.c_int, vp])
    bwd = kbuild.function(klookup.BWD_NAME, "corr_lookup_bwd_probe_bf16",
                          [ptr, vp, vp, vp, ctypes.c_int, vp])
    table, coords = pyramid_inputs(1, H1, W1, torch.bfloat16, seed)
    dev = coords.device
    mixed = q8_table(table)
    for what, tbl in (("bf16 levels 0-3", table),
                      ("int8 levels 0-1, bf16 levels 2-3", mixed),
                      ("int8 levels 0-1", q8_levels(mixed))):
        out = klookup.lookup_pyramid_cuda(tbl, coords, RADIUS)
        tab = klookup._table_struct(tbl, coords, RADIUS, out.shape[-1])
        ms = {"wrapper": time_ms(lambda: klookup.lookup_pyramid_cuda(
            tbl, coords, RADIUS))}
        for name, bits in FWD_PROBES.items():
            ms[name] = time_ms(lambda: kbuild.launch(
                fwd, dev, ctypes.byref(tab), coords.data_ptr(),
                out.data_ptr(), bits))
        emit("lookup_probe", kernel=klookup.NAME, table=what, ms=ms,
             saved_ms={k: ms["kernel"] - v for k, v in ms.items()})
    out = klookup.lookup_pyramid_cuda(table, coords, RADIUS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    acc = [torch.zeros(lv.vol.shape, device="cuda") for lv in table]
    dc = torch.empty_like(coords)
    tab = klookup._table_struct(table, coords, RADIUS, out.shape[-1], acc)
    ms = {"wrapper": time_ms(lambda: klookup.lookup_pyramid_bwd_cuda(
        table, coords, g, RADIUS, acc))}
    for name, bits in BWD_PROBES.items():
        ms[name] = time_ms(lambda: kbuild.launch(
            bwd, dev, ctypes.byref(tab), coords.data_ptr(), g.data_ptr(),
            dc.data_ptr(), bits))
    emit("lookup_probe", kernel=klookup.BWD_NAME, ms=ms,
         saved_ms={k: ms["kernel"] - v for k, v in ms.items()})


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


def damp_head(model):
    """Scale the Bezier head's last weight by 0.02: with it the random-init
    recurrence is contractive, as a trained one is; without it, flows
    reach hundreds of pixels within 12 iterations."""
    with torch.no_grad():
        model.update_block.bezier_head.conv2.weight.mul_(0.02)
    return model


def damped_pair(cfg, seed):
    """The same seeded weights, Bezier head damped (damp_head), as a
    kernel-path and a plain-path model."""
    kern = damp_head(bt.build_model(
        dataclasses.replace(cfg, lookup_method="pallas"), "cuda", seed))
    plain = bt.build_model(dataclasses.replace(cfg, lookup_method="gather"),
                           "cuda", seed)
    plain.load_state_dict(kern.state_dict())
    return kern, plain


# ---------------------------------------------------------------------------
# the train phase: the DSEC training step at full width


def train_config():
    """The flagship as the DSEC experiment E_I_LU4_BD2_lowpyramid trains
    it: f32 correlation and compute (config/model/raft_base.yaml), 12
    iterations, everything else the flagship's."""
    return dataclasses.replace(bt.flagship_config(),
                               corr_precision="float32",
                               compute_dtype="float32")


def train_batch(seed: int, device="cuda"):
    """A seeded synthetic DSEC batch in the layouts of the JAX train step:
    B=3 at the 288x384 training crop, a few pixels of flow, 90% valid."""
    rng = np.random.default_rng(seed)
    cfg = train_config()
    b = {
        "ev_repr": rng.standard_normal(
            (TRAIN_B, TRAIN_H, TRAIN_W, cfg.nbins_total)).astype(np.float32),
        "img": rng.integers(0, 255, (2, TRAIN_B, TRAIN_H, TRAIN_W, 3)
                            ).astype(np.float32),
        "flow": (3.0 * rng.standard_normal((TRAIN_B, TRAIN_H, TRAIN_W, 2))
                 ).astype(np.float32),
        "flow_valid": rng.random((TRAIN_B, TRAIN_H, TRAIN_W)) < 0.9,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def build_corr_pyramid_shapes(cfg, n=TRAIN_B, h=TRAIN_H, w=TRAIN_W):
    """The lookup volumes of a train batch, per level, as the pyramid
    holds them (Tl, N, h1, w1, hl, wl): the dVol accumulators are zeroed,
    and autograd would sum per-iteration dVols, in this shape."""
    from bflow_tpu_torch.models.corr import level_target_indices

    h, w = h // 8, w // 8
    return [(len(idx), n, h, w, h >> lvl, w >> lvl)
            for lvl, idx in enumerate(
                level_target_indices(cfg.levels_per_target))]


def dvol_ops(fn, vol_shapes) -> dict:
    """torch.profiler over one fn(): the calls of fills (zeroing the dVol
    accumulators) and of adds (autograd summing per-iteration dVols) on
    tensors of the lookup volumes' shapes (vol_shapes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    want = [list(v) for v in vol_shapes]
    calls = {"dvol_zero": 0, "dvol_sum": 0}
    for evt in prof.key_averages(group_by_input_shape=True):
        kind = {"aten::fill_": "dvol_zero", "aten::add": "dvol_sum",
                "aten::add_": "dvol_sum"}.get(evt.key)
        if kind and list((evt.input_shapes or [[]])[0]) in want:
            calls[kind] += evt.count
    return calls


def grads_finite(model) -> bool:
    return bool(torch.stack([torch.isfinite(p.grad).all()
                             for p in model.parameters()
                             if p.grad is not None]).all())


def step_grads(cfg, batch, seed, damp: bool, plain: bool = False):
    """Loss and every parameter's gradient of one train step from the
    seeded weights, through make_train_step (its forward and backward run
    in full f32 whatever the process's TF32 flags) with an optimizer that
    leaves the weights as they are; plain: every kernel of the path
    through its plain twin (plain_twins)."""
    from bflow_tpu_torch.train.step import TaskConfig, make_train_step

    model = bt.build_model(cfg, "cuda", seed)
    if damp:
        damp_head(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_train_step(model, TaskConfig("dsec"), opt,
                           torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1))
    with plain_twins() if plain else contextlib.nullcontext():
        metrics = step(batch)
    return (metrics["train/l1_seq_loss"][0].item(),
            {k: p.grad for k, p in model.named_parameters()})


def grad_rel(ga, gp):
    """(worst relative gradient difference, its parameter): each gradient
    against its own max |grad|, or 1e-2 of the model's largest where that
    is larger (conv biases in front of a norm have gradient 0 in exact
    arithmetic and hold round-off on both paths: fnet_img.conv1.bias, 9e-5
    of its own max between two gather runs)."""
    gmax = max(g.abs().max().item() for g in gp.values())
    return max(((ga[k] - gp[k]).abs().max().item()
                / max(gp[k].abs().max().item(), 1e-2 * gmax), k)
               for k in gp)


def train_parity(cfg, batch, seed, damp: bool):
    """Kernel path vs gather path from the same weights: loss and every
    parameter's gradient of one train-mode forward/backward."""
    # deterministic cuDNN algorithms: the default ones may sum with
    # atomics, and their run-to-run spread (7e-5 of a weight gradient's
    # max, f32) would sit at the bound
    torch.backends.cudnn.deterministic = True
    lk, gk = step_grads(dataclasses.replace(cfg, lookup_method="pallas"),
                        batch, seed, damp)
    gather = dataclasses.replace(cfg, lookup_method="gather")
    lp, gp = step_grads(gather, batch, seed, damp)
    _, gp2 = step_grads(gather, batch, seed, damp)
    torch.backends.cudnn.deterministic = False
    # the gather path's own run-to-run spread (its backward scatters with
    # atomics), as the floor of what the comparison can resolve
    return abs(lk - lp) / abs(lp), grad_rel(gk, gp), grad_rel(gp2, gp)


# ---------------------------------------------------------------------------
# phase 3c: the opt-in kernels (int8 lookup, stem conv, conv3x3)


def q8_table(table):
    """A bf16 level table as pallas_q8 holds it: the levels whose row
    count the copied gate quantizes as int8 volumes with their row
    scales (quantize_volume), the others as they are."""
    out = []
    for lv in table:
        if quantizes(lv.vol.shape[4]):
            vq, scale = klookup.quantize_volume(lv.vol)
            lv = klookup.TableLevel(vq, lv.targets, lv.level, scale)
        out.append(lv)
    return out


def q8_levels(table):
    """The int8 levels of a table: row 2's own table."""
    return [lv for lv in table if lv.vol.dtype == torch.int8]


def check_q8_level(Tl, hl, wl, seed):
    """The one-level int8 entry (the forward kernel with a one-level int8
    table) vs its plain twin at one level shape, on a bf16 volume
    quantized as the model quantizes it (one scale per (target, batch,
    query row)), bit-equal; returns the record."""
    vol, coords = level_inputs(Tl, hl, wl, torch.bfloat16, seed)
    vq, scale = klookup.quantize_volume(vol.reshape(Tl, 1, H1, W1, hl, wl))
    vq = vq.reshape(vol.shape)
    got = klookup.corr_lookup_level_q8(vq, scale, coords, RADIUS)
    torch.cuda.synchronize()
    want = klookup.corr_lookup_level_q8_plain(vq, scale, coords, RADIUS)
    check(got.dtype == want.dtype == torch.bfloat16
          and got.shape == want.shape, f"q8 output {got.dtype} {got.shape}")
    err = (got.float() - want.float()).abs().max().item()
    return {"Tl": Tl, "hl": hl, "wl": wl, "queries": vol.shape[0],
            "dtype": "int8", "max_abs_err": err,
            "max_abs_ref": want.float().abs().max().item(), "ok": err == 0.0}


def check_q8_pyramid(n, h1, w1, seed, timing=True,
                     targets=PYRAMID_TARGETS):
    """Phase 3c, the lookup under pallas_q8: the all-level forward over
    the opt-in table (int8 levels 0-1 beside bf16 levels 2-3 at the
    flagship, one launch) and over its int8 levels alone (row 2's own
    table), each exact against its plain twin and per level against the
    one-level entries; with timing, also the bf16 levels alone (what the
    opt-in path launched besides the int8 kernel before the int8 levels
    joined the table). Returns (mixed record, int8-only record)."""
    table, coords = pyramid_inputs(n, h1, w1, torch.bfloat16, seed,
                                   targets=targets)
    mixed = q8_table(table)
    check(any(lv.scale is not None for lv in mixed),
          "no level of the table quantizes")
    rec_mixed = _table_record(mixed, coords, timing)
    rec_q8 = _table_record(q8_levels(mixed), coords, timing)
    rest = [lv for lv in mixed if lv.scale is None]
    if timing and rest:
        rec_mixed["bf16_levels_alone_ms"] = time_ms(
            lambda: klookup.lookup_pyramid_cuda(rest, coords, RADIUS))
    return rec_mixed, rec_q8


def flagship_convs(cfg, n=1, h=H, w=W, iters=ITERS):
    """Every conv of a forward at batch n and h x w that the opt-in modes
    may send to a kernel, with the kernel that the copied JAX gates pick
    for it (None: it stays on F.conv2d) and its count per forward. Rows of
    the same kernel and shape are merged."""
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    rows = {}

    def add(what, N, C, hh, ww, O, kh, kw, stride, relu, times, use):
        nhwc = (N, hh, ww, C)
        kern = None
        if use and stride == 1 and kconv.supported(nhwc, cdt, O, kh, kw):
            kern = kconv.NAME
        elif use and stride == 2 and kstem.supported(nhwc, cdt, kh, kw):
            kern = kstem.NAME
        key = (kern, N, C, hh, ww, O, kh, kw, stride, relu)
        row = rows.setdefault(key, {
            "kernel": kern, "what": [], "shape": [N, C, hh, ww],
            "cout": O, "kh": kh, "kw": kw, "stride": stride, "relu": relu,
            "per_forward": 0})
        row["what"].append(what)
        row["per_forward"] += times

    ctx_in = cfg.nbins_context + 3 * cfg.use_images
    encoders = [("fnet_ev", 5 * n, cfg.nbins_correlation),
                ("fnet_img", 2 * n, 3), ("cnet", n, ctx_in)]
    for name, N, cin in encoders:
        add(f"{name} stem 7x7/s2", N, cin, h, w, 64, 7, 7, 2, False, 1,
            cfg.pallas_stem)
        hh, ww, c = h // 2, w // 2, 64
        for stage, planes in ((1, 64), (2, 96), (3, 128)):
            s = 1 if stage == 1 else 2
            add(f"{name} layer{stage}_0.conv1 3x3/s{s}", N, c, hh, ww,
                planes, 3, 3, s, False, 1, cfg.pallas_conv)
            hh, ww = (hh - 1) // s + 1, (ww - 1) // s + 1
            # layer{stage}_0.conv2, layer{stage}_1.conv1 and .conv2
            add(f"{name} layer{stage} 3x3", N, planes, hh, ww, planes, 3, 3,
                1, False, 3, cfg.pallas_conv)
            c = planes
    h1, w1, pc = h // 8, w // 8, cfg.pallas_conv
    d, bz = cfg.hidden_dim, 2 * cfg.bezier_degree
    gin = d + cfg.context_dim + cfg.motion_dim
    add("update convc2 3x3", n, 256, h1, w1, 192, 3, 3, 1, True, iters, pc)
    add("update convf1 7x7", n, bz, h1, w1, 128, 7, 7, 1, False, iters, pc)
    add("update convf2 3x3", n, 128, h1, w1, 64, 3, 3, 1, True, iters, pc)
    add("update conv 3x3", n, 256, h1, w1, cfg.motion_dim - bz, 3, 3, 1,
        True, iters, pc)
    for kh, kw in ((1, 5), (5, 1)):
        add(f"update gru fused [z|r|q_x] {kh}x{kw}", n, gin, h1, w1, 3 * d,
            kh, kw, 1, False, iters, pc)
        add(f"update gru r*h {kh}x{kw}", n, d, h1, w1, d, kh, kw, 1, False,
            iters, pc)
    add("update bezier_head.conv1 / mask_0 3x3", n, d, h1, w1, 256, 3, 3, 1,
        True, 2 * iters, pc)
    add("update bezier_head.conv2 3x3", n, 256, h1, w1, bz, 3, 3, 1, False,
        iters, pc)
    return list(rows.values())


def norm_encoders(cfg, train: bool = False) -> int:
    """Encoders whose norms go through the norm kernel in one forward: each
    bf16 or f32 encoder with instance norms or eval-mode BatchNorms, none
    in a training forward (autograd records the norms; train-mode
    BatchNorm takes the batch's statistics)."""
    if train or getattr(torch, cfg.compute_dtype) not in knorm.DTYPES:
        return 0
    kinds = ([cfg.feature_norm] * (cfg.use_events + cfg.use_images)
             + [cfg.context_norm])
    return sum(k in ("instance", "batch") for k in kinds)


def norm_launches(cfg, train: bool = False) -> int:
    """Norm kernel launches in one forward: 15 an encoder of
    norm_encoders (the stem's, four a stage and the downsample's in stages
    2 and 3)."""
    return 15 * norm_encoders(cfg, train)


def residual_launches(cfg, train: bool = False) -> int:
    """Of those, the norms that take their residual block's epilogue: the
    second norm of each of an encoder's six blocks (the shortcut in the
    layout of the norm's input: the conv kernels and the 1x1 downsample
    hand over the same)."""
    return 6 * norm_encoders(cfg, train)


def proj_launches(cfg, n, h, w, iters, train=False) -> int:
    """convc1 kernel launches in one forward: one an iteration where the
    fused convc1 reads a bf16 map (bf16 volumes and compute; the onehot
    method's map is f32) of a multiple of 8 rows, in a forward that
    autograd does not record."""
    bf16_map = (cfg.compute_dtype == cfg.corr_precision == "bfloat16"
                and cfg.lookup_method != "onehot")
    rows = n * (h // 8) * (w // 8)
    return iters * (not train and cfg.fuse_corr_conv and bf16_map
                    and rows % kproj.ROWS == 0)


def expected_launches(cfg, n=1, h=H, w=W, iters=ITERS, train=False):
    """Launches of each kernel in one forward (``train``: a training
    forward, autograd recording), from the copied gates."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    for row in flagship_convs(cfg, n, h, w, iters):
        if row["kernel"]:
            want[row["kernel"]] += row["per_forward"]
    want[kconv.PIPELINED_NAME] = sum(
        row["per_forward"] for row in flagship_convs(cfg, n, h, w, iters)
        if row["kernel"] == kconv.NAME and conv_pipelined(row))
    want[knorm.NAME] = norm_launches(cfg, train)
    want[knorm.RESIDUAL_NAME] = residual_launches(cfg, train)
    want[kproj.NAME] = proj_launches(cfg, n, h, w, iters, train)
    # a level for the all-level kernel (pallas_q8's int8 levels too): one
    # launch per iteration
    table = cfg.lookup_method in KERNEL_METHODS and any(
        not 0 <= cfg.onehot_from_level <= lvl
        for lvl in range(max(cfg.levels_per_target)))
    want[klookup.NAME] += iters * table
    return want


def conv_mok(row):
    """(M, O, K, Cp) of a conv row: its product's shape."""
    N, C, hh, ww = row["shape"]
    s = row["stride"]
    cp = -(-C // 8) * 8
    m = N * ((hh - 1) // s + 1) * ((ww - 1) // s + 1)
    return m, row["cout"], row["kh"] * row["kw"] * cp, cp


def conv_pipelined(row) -> bool:
    """Whether launch_plan sends a stride-1 conv row to the pipelined loop
    (csrc/conv_pipe.cuh)."""
    return row["stride"] == 1 and conv_common.pipelined(*conv_mok(row))


# the bf16 DSEC cell's batch (benchmark/workloads/dsec_ei_bf16.eval_b16.json)
BF16_CELL_BATCH = 16


def conv_bound(row):
    """(operations, bytes, bound ms) of one launch of a conv row: the input
    read once, the weights, the f32 bias and the output written once."""
    N, C, hh, ww = row["shape"]
    s = row["stride"]
    ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
    flops = 2 * N * ho * wo * row["cout"] * C * row["kh"] * row["kw"]
    nbytes = 2 * (N * C * hh * ww + row["cout"] * C * row["kh"] * row["kw"]
                  + N * row["cout"] * ho * wo) + 4 * row["cout"]
    return flops, nbytes, max(flops / BF16_FLOPS,
                              nbytes / HBM_BYTES_PER_S) * 1e3


def conv_inputs(row, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, C, hh, ww = row["shape"]
    x = torch.randn(N, C, hh, ww, generator=gen, device="cuda").bfloat16()
    fan = C * row["kh"] * row["kw"]
    w = (torch.randn(row["cout"], C, row["kh"], row["kw"], generator=gen,
                     device="cuda") / fan ** 0.5)
    b = 0.1 * torch.randn(row["cout"], generator=gen, device="cuda")
    return x, w, b


def _conv_call(row, x, w, b):
    if row["stride"] == 1:
        return lambda: kconv.conv2d(x, w, b, row["relu"])
    return lambda: kstem.stem_conv(x, w, b)


def check_conv(row, seed, timing=True):
    """A conv kernel vs its plain twin at one flagship shape (output to
    TOL of max |plain|), on a channels-last x (what the model hands it)
    and on an NCHW-contiguous one (bit-equal); what the wrapper does
    around the kernel: a channels-last output, a second call with no
    weight prepared and no layout copy (one copy where C is not a multiple
    of 8) and a bit-equal result, a prepared weight made anew after an
    in-place update of the parameter; and the gradients through its
    autograd.Function vs autograd through the plain formulation of the JAX
    package's VJP. Returns the phase-3c record."""
    x, w, b = conv_inputs(row, seed)  # x NCHW-contiguous
    x_cl = x.contiguous(memory_format=torch.channels_last)
    stride, relu = row["stride"], row["relu"]
    N, C, hh, ww = row["shape"]
    ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    call = _conv_call(row, x_cl, w, b)
    got = call()
    torch.cuda.synchronize()
    want = conv_common.conv_plain(x, w, b, stride, relu)
    check(got.dtype == want.dtype == torch.bfloat16
          and got.shape == want.shape, f"conv output {got.dtype} {got.shape}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = TOL[torch.bfloat16]
    nchw_equal = torch.equal(_conv_call(row, x, w, b)(), got)
    conv_common.reset_counters()
    again = call()
    copies, preps = conv_common.layout_copies, conv_common.weight_preps
    # doubling the parameters in place is exact in bf16 and f32: a stale
    # prepared weight would show as an output that did not double
    prep = conv_common.prepared(w, b)
    w.mul_(2.0)
    b.mul_(2.0)
    followed = (conv_common.prepared(w, b) is not prep
                and torch.equal(call(), got * 2))
    w.mul_(0.5)
    b.mul_(0.5)
    wrapper = {
        "channels_last_out": got.is_contiguous(
            memory_format=torch.channels_last),
        "nchw_input_bit_equal": nchw_equal,
        "bitwise_repeatable": torch.equal(again, got),
        "second_call_layout_copies": copies,
        "second_call_weight_preps": preps,
        "follows_in_place_update": followed}
    wrapper_ok = (wrapper["channels_last_out"] and nchw_equal
                  and wrapper["bitwise_repeatable"] and followed
                  and preps == 0 and copies == int(C % 8 != 0))
    # gradients: kernel forward + the VJP against autograd of the plain
    # bf16 formulation (the same gradient function: equal)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g = torch.randn(got.shape, generator=gen, device="cuda").bfloat16()
    leaves = [t.detach().requires_grad_(True) for t in (x_cl, w, b)]
    _conv_call(row, *leaves)().backward(g)
    ref_leaves = [t.detach().requires_grad_(True) for t in (x_cl, w, b)]
    conv_common.conv_ref_bf16(*ref_leaves, stride, relu).backward(g)
    grad_err = max(((a.grad.float() - r.grad.float()).abs().max()
                    / r.grad.float().abs().max().clamp(min=1e-30)).item()
                   for a, r in zip(leaves, ref_leaves))
    flops, nbytes, bound_ms = conv_bound(row)
    m, o, k, cp = conv_mok(row)
    plan = conv_common.launch_plan(m, o, k, cp, stride)
    rec = {**row, "max_abs_err": err, "max_abs_ref": ref, "tol_rel": tol,
           "grad_rel_err": grad_err, "flops": flops, "bytes": nbytes,
           "tile_plan": dataclasses.asdict(plan), **wrapper,
           "ok": err <= tol * ref and grad_err <= tol and wrapper_ok}
    if not timing:
        return rec
    wb, bb = w.bfloat16(), b.bfloat16()
    wb_cl = wb.contiguous(memory_format=torch.channels_last)
    pad = (row["kh"] // 2, row["kw"] // 2)
    rec.update(
        ms=time_ms(call),
        ms_nchw_input=time_ms(_conv_call(row, x, w, b)),
        plain_ms=time_ms(lambda: conv_common.conv_plain(x, w, b, stride,
                                                        relu)),
        bound_ms=bound_ms,
        bound_by=("operations" if flops / BF16_FLOPS
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=time_ms(lambda: F.conv2d(x_cl, wb_cl, bb, stride, pad)),
        library_nchw_ms=time_ms(lambda: F.conv2d(x, wb, bb, stride, pad)),
        library_note="F.conv2d in bf16 (cuDNN), bias in bf16, operands "
                     "channels-last (library_ms) and NCHW-contiguous "
                     "(library_nchw_ms); ms: x channels-last, "
                     "ms_nchw_input: x NCHW-contiguous")
    return rec


def conv_sweep(seed: int) -> None:
    """Every tile variant the conv kernels are built for, forced on every
    flagship conv shape (x channels-last, L2 flushed before each launch):
    the time of the variant tile_plan picks beside all the others', the
    data the plan's rules are fitted to."""
    for i, row in enumerate(flagship_convs(opt_in_config())):
        if row["kernel"] is None:
            continue
        x, w, b = conv_inputs(row, seed + i)
        x = x.contiguous(memory_format=torch.channels_last)
        N, C, hh, ww = row["shape"]
        s = row["stride"]
        ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
        picked = conv_common.tile_plan(N * ho * wo, row["cout"],
                                       row["kh"] * row["kw"] * (-(-C // 8) * 8))
        times = {}
        for plan in conv_common.all_plans():
            if s == 1:
                call = lambda: kconv.conv2d(x, w, b, row["relu"], plan=plan)
            else:
                call = lambda: kstem.stem_conv(x, w, b, plan=plan)
            times[plan] = time_ms(call, reps=7, warmup=2)
        best = min(times, key=times.get)
        emit("conv_sweep", kernel=row["kernel"], shape=row["shape"],
             cout=row["cout"], kh=row["kh"], kw=row["kw"], stride=s,
             picked=dataclasses.astuple(picked), picked_ms=times[picked],
             best=dataclasses.astuple(best), best_ms=times[best],
             picked_over_best=times[picked] / times[best],
             ms={"x".join(map(str, dataclasses.astuple(p))): t
                 for p, t in times.items()})


def conv_loops_phase(seed: int):
    """The conv3x3 kernel's two main loops at every conv3x3 shape of the
    opt-in flagship forward at B=1 and at the bf16 DSEC cell's batch: the
    pipelined loop (csrc/conv_pipe.cuh, 128-pixel tiles of tile_plan's
    channel width) forced beside tile_plan's plan of the other loop
    (csrc/conv_igemm.cuh), on a channels-last input. Where the pipelined
    loop takes the input's channels, its output is bit-equal to the other
    loop's without a K split (the same f32 sums in the same order; a split
    adds partial sums), and each loop's output is within TOL of max |plain|
    of the plain version (conv_common.conv_plain). Each loop's time (CUDA events, L2 flushed) beside
    the bound, and the loop launch_plan takes. Emits a conv_loops line a
    shape and a conv_loops_summary line a batch (each loop's total a
    forward, the routed total, the bound); returns the records."""
    recs = []
    cfg = opt_in_config()
    for n in (1, BF16_CELL_BATCH):
        rows = [r for r in flagship_convs(cfg, n=n)
                if r["kernel"] == kconv.NAME]
        batch = []
        for i, row in enumerate(rows):
            x, w, b = conv_inputs(row, seed + i)
            x = x.contiguous(memory_format=torch.channels_last)
            m, o, k, cp = conv_mok(row)
            other = conv_common.tile_plan(m, o, k)
            plans = {"other": other}
            if cp % 32 == 0:
                plans["pipelined"] = conv_common.pipelined_plan(other.bn)
            unsplit = dataclasses.replace(other, split=1)
            outs = {name: kconv.conv2d(x, w, b, row["relu"], plan=p)
                    for name, p in {**plans, "unsplit": unsplit}.items()}
            want = conv_common.conv_plain(x, w, b, 1, row["relu"]).float()
            torch.cuda.synchronize()
            flops, nbytes, bound = conv_bound(row)
            rec = {"batch": n, "what": row["what"], "shape": row["shape"],
                   "cout": o, "kh": row["kh"], "kw": row["kw"],
                   "relu": row["relu"], "per_forward": row["per_forward"],
                   "m": m, "k": k, "cp": cp, "bn": other.bn,
                   "other_plan": dataclasses.astuple(other),
                   "routed": "pipelined" if conv_pipelined(row) else "other",
                   "bound_ms": bound, "flops": flops, "bytes": nbytes,
                   "tol": TOL[torch.bfloat16]}
            for name in plans:
                rec[f"{name}_err"] = ((outs[name].float() - want).abs().max()
                                      / want.abs().max()).item()
            del want
            if "pipelined" in outs:
                rec["bit_equal"] = torch.equal(outs["pipelined"],
                                               outs["unsplit"])
                rec["bitwise_repeatable"] = torch.equal(
                    kconv.conv2d(x, w, b, row["relu"],
                                 plan=plans["pipelined"]),
                    outs["pipelined"])
            del outs
            for name, p in plans.items():
                rec[f"{name}_ms"] = time_ms(
                    lambda p=p: kconv.conv2d(x, w, b, row["relu"], plan=p),
                    reps=10)
                rec[f"{name}_roofline"] = 100.0 * bound / rec[f"{name}_ms"]
            del x, w, b
            emit("conv_loops", **rec)
            check(rec.get("bit_equal", True)
                  and rec.get("bitwise_repeatable", True)
                  and all(rec[f"{name}_err"] <= rec["tol"] for name in plans),
                  f"the conv3x3 loops disagree: {rec}")
            batch.append(rec)

        def total(key):
            return sum(r[key] * r["per_forward"] for r in batch if key in r)

        routed = sum(r[f"{r['routed']}_ms"] * r["per_forward"]
                     for r in batch)
        emit("conv_loops_summary", batch=n, shapes=len(batch),
             launches=sum(r["per_forward"] for r in batch),
             pipelined_launches=sum(r["per_forward"] for r in batch
                                    if r["routed"] == "pipelined"),
             routed_ms=routed, other_ms=total("other_ms"),
             pipelined_ms=total("pipelined_ms"), bound_ms=total("bound_ms"),
             roofline=100.0 * total("bound_ms") / routed,
             per="forward: each shape's time x its launches")
        recs += batch
    return recs


class plain_twins:
    """Within the block, every kernel of the model's path runs its plain
    PyTorch twin on the card instead (the comparison path of the parity
    phases; the port itself has no such switch)."""

    def __enter__(self):
        self._saved = [(kconv, "_fwd_cuda", kconv._fwd_cuda),
                       (kstem, "_fwd_cuda", kstem._fwd_cuda),
                       (knorm, "_instance_cuda", knorm._instance_cuda),
                       (knorm, "_batch_cuda", knorm._batch_cuda),
                       (kproj, "_proj_cuda", kproj._proj_cuda),
                       (klookup, "lookup_pyramid_cuda",
                        klookup.lookup_pyramid_cuda),
                       (klookup, "lookup_pyramid_bwd_cuda",
                        klookup.lookup_pyramid_bwd_cuda)]
        kconv._fwd_cuda = conv_common.conv_plain
        kstem._fwd_cuda = conv_common.conv_plain
        knorm._instance_cuda = knorm.instance_norm_plain
        knorm._batch_cuda = knorm.batch_norm_plain
        kproj._proj_cuda = kproj.corr_proj_plain
        klookup.lookup_pyramid_cuda = klookup.corr_lookup_pyramid_plain
        klookup.lookup_pyramid_bwd_cuda = (
            klookup.corr_lookup_pyramid_bwd_plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def opt_in_config():
    """The flagship with the JAX package's opt-in modes switched on."""
    return dataclasses.replace(bt.flagship_config(),
                               lookup_method="pallas_q8", pallas_stem=True,
                               pallas_conv=True)


def lookup_fwd_resources(ptxas_log: str):
    """Per instantiation of the lookup forward at the flagship radius, from
    nvcc's -Xptxas -v log: (output type, int8 levels or not, probe) ->
    registers and spill bytes."""
    out = {}
    pat = re.compile(
        r"Compiling entry function '[^']*corr_lookup_fwd_kernelI"
        r"(f|13__nv_bfloat16)Li4ELb([01])ELi(\d+)E[^']*'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for m in pat.finditer(ptxas_log):
        t, q8, probe, st, ld, regs = m.groups()
        key = (f"{'f32' if t == 'f' else 'bf16'} "
               f"{'int8 levels' if q8 == '1' else 'no int8'} probe{probe}")
        out[key] = {"registers": int(regs), "spill_bytes": int(st) + int(ld)}
    return out


def conv_variant_resources(ptxas_log: str):
    """Per instantiation of the conv kernel, from nvcc's -Xptxas -v log:
    (stride, pixel tile, channel tile, stages) -> registers and spill
    bytes. Shared memory is dynamic: TilePlan.smem_bytes. The pipelined
    loop's: (channel tile, weight resident, strips, stages) -> registers
    (before setmaxnreg) and spill bytes."""
    out = {}
    pipe = re.compile(
        r"conv_pipe\d*conv_igemm_kernelILi1ELi(\d+)ELb([01])ELb([01])ELi(\d+)E"
        r".*?(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for m in pipe.finditer(ptxas_log):
        bn, res, strip, stages, st, ld, regs = map(int, m.groups())
        out[f"pipelined bn{bn} resident{res} strip{strip} stages{stages}"] = {
            "registers": regs, "spill_bytes": st + ld}
    pat = re.compile(
        r"conv_igemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for m in pat.finditer(ptxas_log):
        s_, bm, bn, stages, st, ld, regs = map(int, m.groups())
        plan = conv_common.TilePlan(bm, bn, stages, 1)
        out[f"s{s_} bm{bm} bn{bn} stages{stages}"] = {
            "registers": regs, "spill_bytes": st + ld,
            "dynamic_smem_bytes": plan.smem_bytes}
    return out


def conv_summary(name, replaces, recs, counts, eval_counts):
    """A conv kernel's entry of the kernels line: times per flagship
    forward (each shape's time x its launches per forward); launches in
    phase 4b's forwards and in phase 7d's val run."""
    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in recs)

    ops = sum(r["flops"] * r["per_forward"] for r in recs) / BF16_FLOPS
    mem = sum(r["bytes"] * r["per_forward"] for r in recs) / HBM_BYTES_PER_S
    return {"name": name, "route": "cuda",
            "source": f"bflow_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": counts[name],
            "launches_eval": eval_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": "operations" if ops > mem else "bytes",
            "library_ms": per_forward("library_ms"),
            "ms_nchw_input": per_forward("ms_nchw_input"),
            "library_nchw_ms": per_forward("library_nchw_ms"),
            "per": "flagship forward", "shapes": len(recs)}


# ---------------------------------------------------------------------------
# phase 3d: the norm kernel against its plain version

# the encoders' norm shapes (C, H, W) at stages 1-3 of a 480x640 input
NORM_STAGES = [(64, 240, 320), (96, 120, 160), (128, 60, 80)]
# the bf16 DSEC cell's batch of 16: the encoders' N and norm kinds
NORM_ENCODERS = [("fnet_ev", 80, "instance"), ("fnet_img", 32, "instance"),
                 ("cnet", 16, "batch")]
# the kernel against its plain version: bf16 outputs at most one ulp apart
# on at most this share of the elements (the two sum in another order and
# round 1/sqrt differently, which moves an f32 result by ~1e-7 of itself),
# and a difference below NORM_ATOL is the f32 rounding of an output near 0,
# where one ulp of bf16 is smaller than that rounding
NORM_ULP_SHARE = 1e-3
NORM_ATOL = 1e-5


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in units in the last
    place (0 between -0 and +0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def norm_inputs(kind, n, c, h, w, channels_last, seed, device="cuda",
                dtype=torch.bfloat16):
    """x (N, C, H, W) ~ 2 N(0, 1) + 0.5 in ``dtype`` and the asked layout
    and, for a BatchNorm, running mean and variance, weight and bias
    (f32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2.0 * torch.randn(n, c, h, w, generator=gen, device=device)
         + 0.5).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    if kind == "instance":
        return x, ()

    def draw():
        return torch.randn(c, generator=gen, device=device)

    return x, (0.2 * draw(), 0.5 + draw().abs(), 1.0 + 0.2 * draw(),
               0.2 * draw())


def norm_call(kind, x, stats, relu, plain=False, residual=None):
    """The kernel (or its plain version) on x, with the residual epilogue
    where there is a residual, as a function of no arguments."""
    if kind == "instance":
        fn = knorm.instance_norm_plain if plain else knorm.instance_norm
        return lambda: fn(x, relu, residual)
    fn = knorm.batch_norm_plain if plain else knorm.batch_norm
    return lambda: fn(x, *stats, 1e-5, relu, residual)


def norm_bytes(kind, x) -> dict:
    """The norm's bytes: the input read once and the output written once
    (the roofline's count), and what a two-pass instance norm reads from
    device memory when its second read misses the L2."""
    once = 4 * x.numel()
    return {"bytes": once,
            "bytes_two_pass": once + (2 * x.numel() if kind == "instance"
                                      else 0)}


def check_norm(kind, n, c, h, w, channels_last, seed, relu=True,
               timing=False):
    """The norm kernel against its plain version on the card: every bf16
    output within one ulp (or NORM_ATOL) of the plain one, at most
    NORM_ULP_SHARE of them one ulp off; a second launch bit-equal; the
    output in the input's layout; one launch counted a call. With timing:
    the kernel's ms (L2 flushed before each launch) beside its byte bound,
    the plain version's ms (the eager f32 chain the model ran before the
    kernel) and the library's: F.instance_norm or F.batch_norm in bf16,
    then F.relu, which the port never calls."""
    x, stats = norm_inputs(kind, n, c, h, w, channels_last, seed)
    before = knorm.launches
    call = norm_call(kind, x, stats, relu)
    got = call()
    again = call()
    torch.cuda.synchronize()
    launches = knorm.launches - before
    want = norm_call(kind, x, stats, relu, plain=True)()
    ulps = bf16_ulps(got, want)
    near = (got.float() - want.float()).abs() <= NORM_ATOL
    layout = (torch.channels_last if channels_last
              else torch.contiguous_format)
    rec = {"kind": kind, "shape": [n, c, h, w],
           "layout": "channels_last" if channels_last else "nchw",
           "relu": relu, "max_ulps": int(ulps.max().item()),
           "max_ulps_beyond_atol": int(ulps.masked_fill(near, 0).max().item()),
           "share_off_by_one_ulp": (ulps == 1).float().mean().item(),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeatable": torch.equal(got, again),
           "layout_kept": got.is_contiguous(memory_format=layout),
           "launches_per_call": launches / 2,
           "chunks": knorm.chunks(n, c, h * w, channels_last),
           "ulp_share_bound": NORM_ULP_SHARE, "atol": NORM_ATOL}
    rec["ok"] = (rec["max_ulps_beyond_atol"] <= 1
                 and rec["share_off_by_one_ulp"] <= NORM_ULP_SHARE
                 and rec["bitwise_repeatable"] and rec["layout_kept"]
                 and launches == 2)
    if not timing:
        return rec
    del got, again, want, ulps, near
    nbytes = norm_bytes(kind, x)
    if kind == "instance":
        def library():
            return F.relu(F.instance_norm(x, eps=1e-5))
    else:
        def library():
            return F.relu(F.batch_norm(x, *stats, False, 0.0, 1e-5))
    rec.update(
        nbytes,
        ms=time_ms(call),
        plain_ms=time_ms(norm_call(kind, x, stats, relu, plain=True)),
        library_ms=time_ms(library),
        bound_ms=nbytes["bytes"] / HBM_BYTES_PER_S * 1e3,
        bound_two_pass_ms=nbytes["bytes_two_pass"] / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    rec["two_pass_roofline_share"] = rec["bound_two_pass_ms"] / rec["ms"]
    return rec


def check_norm_residual(kind, n, c, h, w, channels_last, seed,
                        timing=False):
    """The kernel with a residual block's epilogue (ReLU fused, then
    relu(x + y)) against the eager chain it replaces, the kernel without a
    residual followed by PyTorch's bf16 add and ReLU: equal to the last
    bit; a second launch bit-equal; the output in the input's layout; one
    launch, and one residual launch, counted a call. With timing: its ms
    (L2 flushed) beside its byte bound (z read twice for an instance norm,
    once for a BatchNorm, x read once, the output written once), the eager
    chain's ms (what the model ran before) and the plain version's."""
    z, stats = norm_inputs(kind, n, c, h, w, channels_last, seed)
    x, _ = norm_inputs("instance", n, c, h, w, channels_last, seed + 1)
    before = (knorm.launches, knorm.residual_launches)
    call = norm_call(kind, z, stats, True, residual=x)
    got = call()
    again = call()
    torch.cuda.synchronize()
    launches = (knorm.launches - before[0],
                knorm.residual_launches - before[1])
    unfused = norm_call(kind, z, stats, True)

    def eager():
        return F.relu(x + unfused())

    want = eager()
    layout = (torch.channels_last if channels_last
              else torch.contiguous_format)
    bits = got.contiguous().view(torch.int16) != want.contiguous().view(
        torch.int16)
    rec = {"kind": kind, "shape": [n, c, h, w],
           "layout": "channels_last" if channels_last else "nchw",
           "residual": True, "equal": torch.equal(got, want),
           "bits_differing": int(bits.sum().item()),
           "bitwise_repeatable": torch.equal(got, again),
           "layout_kept": got.is_contiguous(memory_format=layout),
           "launches_per_call": launches[0] / 2,
           "residual_launches_per_call": launches[1] / 2}
    rec["ok"] = (rec["equal"] and rec["bitwise_repeatable"]
                 and rec["layout_kept"] and launches == (2, 2))
    if not timing:
        return rec
    del got, again, want, bits
    reads = 2 if kind == "instance" else 1
    nbytes = (2 * reads + 4) * z.numel()
    rec.update(
        bytes=nbytes, bytes_per_element=nbytes / z.numel(),
        ms=time_ms(call),
        eager_ms=time_ms(eager),
        plain_ms=time_ms(norm_call(kind, z, stats, True, plain=True,
                                   residual=x)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    return rec


# the f32 cells' encoder norms: (cell, encoder, N at B=8, norm kind) and
# each cell's stages (C, H, W): DSEC at 480x640, MultiFlow at 384x512;
# fnet_ev takes the reference and each event target's slice of a sample
NORM_F32_ENCODERS = [("dsec_ei", "fnet_ev", 40, "instance"),
                     ("dsec_ei", "fnet_img", 16, "instance"),
                     ("dsec_ei", "cnet", 8, "batch"),
                     ("mf_ei", "fnet_ev", 48, "instance"),
                     ("mf_ei", "fnet_img", 16, "instance"),
                     ("mf_ei", "cnet", 8, "batch")]
NORM_F32_STAGES = {"dsec_ei": NORM_STAGES,
                   "mf_ei": [(64, 192, 256), (96, 96, 128), (128, 48, 64)]}
# every encoder norm shape of the f32 cells: (kind, N, C, H, W)
NORM_F32_SHAPES = [(kind, n, *chw) for cell, _, n, kind in NORM_F32_ENCODERS
                   for chw in NORM_F32_STAGES[cell]]
# the f32 kernel against the eager chain: at most this many units of
# 2^-23 x max|eager| apart. The two take the statistics in another order
# (the kernel joins per-thread moments by Chan's update, PyTorch's mean
# reduces in its own tree) and round 1/sqrt(var + eps) differently, which
# moves an output by a few ulp of itself
NORM_F32_ULPS = 8


def check_norm_f32(kind, n, c, h, w, channels_last, seed, epilogue="relu",
                   timing=False):
    """``epilogue``: "plain" (the norm alone), "relu", or "residual" (a
    residual block's ReLU, then relu(x + y) with a drawn shortcut x).

    The f32 kernel against the eager chain the model ran before it, its
    plain version (the two-pass instance norm or F.batch_norm in f32, the
    ReLU, relu(x + y) for a residual): within NORM_F32_ULPS x 2^-23 of
    max|eager|; a second launch bit-equal; the output f32 in the input's
    layout; one launch (and one residual launch with a residual) counted a
    call. With timing: its ms (L2 flushed) beside its byte bounds (the
    input read once and the output written once, with the residual read
    once: 8 and 12 bytes an element; what it moves, x read twice for an
    instance norm: 12 and 16; a three-pass kernel's, x read for the mean,
    the variance and the normalise: 16 and 20) and the eager chain's
    ms."""
    z, stats = norm_inputs(kind, n, c, h, w, channels_last, seed,
                           dtype=torch.float32)
    res = None
    if epilogue == "residual":
        res, _ = norm_inputs("instance", n, c, h, w, channels_last, seed + 1,
                             dtype=torch.float32)
    relu = epilogue != "plain"
    before = (knorm.launches, knorm.residual_launches)
    call = norm_call(kind, z, stats, relu, residual=res)
    got = call()
    again = call()
    torch.cuda.synchronize()
    launches = (knorm.launches - before[0],
                knorm.residual_launches - before[1])
    eager = norm_call(kind, z, stats, relu, plain=True, residual=res)
    want = eager()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    layout = (torch.channels_last if channels_last
              else torch.contiguous_format)
    rec = {"kind": kind, "dtype": "float32", "shape": [n, c, h, w],
           "layout": "channels_last" if channels_last else "nchw",
           "epilogue": epilogue, "max_abs_err": err, "max_abs_eager": scale,
           "err_ulps_of_max": err / (scale * 2.0 ** -23),
           "ulps_bound": NORM_F32_ULPS,
           "bitwise_repeatable": torch.equal(got, again),
           "layout_kept": (got.dtype == torch.float32
                           and got.is_contiguous(memory_format=layout)),
           "launches_per_call": launches[0] / 2,
           "residual_launches_per_call": launches[1] / 2,
           "chunks": knorm.chunks(n, c, h * w, channels_last)}
    rec["ok"] = (rec["err_ulps_of_max"] <= NORM_F32_ULPS
                 and rec["bitwise_repeatable"] and rec["layout_kept"]
                 and launches == (2, 2 * (res is not None)))
    if not timing:
        return rec
    del got, again, want
    extra = 4 * (res is not None)  # the shortcut's read
    per = {"bytes": 8 + extra,
           "bytes_moved": (12 if kind == "instance" else 8) + extra,
           "bytes_three_pass": (16 if kind == "instance" else 8) + extra}
    rec.update({k: v * z.numel() for k, v in per.items()},
               ms=time_ms(call), eager_ms=time_ms(eager), bound_by="bytes")
    for k in per:
        bound = rec[k] / HBM_BYTES_PER_S * 1e3
        rec[k.replace("bytes", "bound") + "_ms"] = bound
        rec[k.replace("bytes", "roofline_share")] = bound / rec["ms"]
    return rec


def norm_f32_phase(seed: int, timing: bool = True):
    """Phase 3d, f32: the kernel at every encoder norm shape of the f32
    eval cells, channels-last as the cells run it (the probe of the f32
    forward on the card finds every norm input and shortcut channels-last),
    with the ReLU and with the residual epilogue; at each DSEC stage in
    NCHW at N=2, both kinds, plain and with the residual; then timed at
    fnet_ev's stage 1 in the DSEC cell (N=40, 64x240x320), NCHW and
    channels-last, with the ReLU and with the residual."""
    recs = []
    for i, (kind, n, c, h, w) in enumerate(NORM_F32_SHAPES):
        for epilogue in ("relu", "residual"):
            recs.append(check_norm_f32(kind, n, c, h, w, True, seed + 2 * i,
                                       epilogue))
    for j, (c, h, w) in enumerate(NORM_STAGES):
        for kind in ("instance", "batch"):
            for epilogue in ("plain", "residual"):
                recs.append(check_norm_f32(kind, 2, c, h, w, False,
                                           seed + 50 + j, epilogue))
    if timing:
        kind, n, c, h, w = NORM_F32_SHAPES[0]
        for channels_last in (False, True):
            for epilogue in ("relu", "residual"):
                rec = check_norm_f32(kind, n, c, h, w, channels_last,
                                     seed + 70, epilogue, timing=True)
                rec["encoder"] = "fnet_ev"
                recs.append(rec)
    for rec in recs:
        emit("kernel", name=knorm.NAME, **rec)
        check(rec["ok"], f"f32 norm kernel disagrees: {rec}")
    return recs


def norm_phase(seed: int, timing: bool = True):
    """Phase 3d: the norm kernel at each encoder shape of the bf16 DSEC
    cell (B=16: fnet_ev's 80 samples, fnet_img's 32, cnet's 16 through
    BatchNorm), channels-last as the conv kernels hand it over, ReLU fused,
    timed; then NCHW (the 1x1 downsample's F.conv2d may answer in it) at
    each stage with N=2, ReLU off; then the residual epilogue at every
    encoder shape, channels-last, timed at fnet_ev's stage 1, and in NCHW
    at N=2. Returns the records and the kernel's device ms a request (each
    stage's time x 5 norms, per encoder, without the residual)."""
    recs, request_ms = [], 0.0
    for i, (enc, n, kind) in enumerate(NORM_ENCODERS):
        for j, (c, h, w) in enumerate(NORM_STAGES):
            rec = check_norm(kind, n, c, h, w, True, seed + 3 * i + j,
                             timing=timing)
            rec["encoder"] = enc
            emit("kernel", name=knorm.NAME, **rec)
            check(rec["ok"], f"norm kernel disagrees: {rec}")
            recs.append(rec)
            if timing:
                request_ms += 5 * rec["ms"]
    for j, (c, h, w) in enumerate(NORM_STAGES):
        for kind in ("instance", "batch"):
            rec = check_norm(kind, 2, c, h, w, False, seed + 20 + j,
                             relu=False)
            emit("kernel", name=knorm.NAME, **rec)
            check(rec["ok"], f"norm kernel disagrees (NCHW): {rec}")
            recs.append(rec)
    for i, (enc, n, kind) in enumerate(NORM_ENCODERS):
        for j, (c, h, w) in enumerate(NORM_STAGES):
            rec = check_norm_residual(kind, n, c, h, w, True,
                                      seed + 40 + 3 * i + j,
                                      timing=timing and i == j == 0)
            rec["encoder"] = enc
            emit("kernel", name=knorm.RESIDUAL_NAME, **rec)
            check(rec["ok"], f"norm kernel's residual epilogue differs from "
                             f"the eager chain: {rec}")
            recs.append(rec)
    for j, (c, h, w) in enumerate(NORM_STAGES):
        for kind in ("instance", "batch"):
            rec = check_norm_residual(kind, 2, c, h, w, False, seed + 60 + j)
            emit("kernel", name=knorm.RESIDUAL_NAME, **rec)
            check(rec["ok"], f"norm kernel's residual epilogue differs from "
                             f"the eager chain (NCHW): {rec}")
            recs.append(rec)
    return recs, request_ms


def norm_summary(recs, request_ms, counts, eval_counts, f32_recs=()):
    """The norm kernel's entry of the kernels line: the stage-1 instance
    norm of fnet_ev (N=80, 64x240x320, channels-last) and the request's
    total at B=16; launches in phase 4's forwards and phase 7d's val run;
    the f32 instantiation at fnet_ev's stage 1 in the DSEC f32 cell (N=40)
    by layout and epilogue."""
    top = next(r for r in recs if r.get("encoder") == "fnet_ev"
               and r["shape"][1] == NORM_STAGES[0][0]
               and not r.get("residual"))
    res = next(r for r in recs if r.get("encoder") == "fnet_ev"
               and r["shape"][1] == NORM_STAGES[0][0] and r.get("residual"))
    return {"name": knorm.NAME, "route": "cuda",
            "source": "bflow_tpu_torch/csrc/norm.cu",
            "replaces": "none: XLA fuses the JAX package's norm "
                        "(bflow_tpu/models/extractor.py:Norm)",
            "launches": counts[knorm.NAME],
            "launches_eval": eval_counts[knorm.NAME],
            "max_ulps_beyond_atol": max(r["max_ulps_beyond_atol"]
                                        for r in recs
                                        if not r.get("residual")),
            **{k: top[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_two_pass_ms",
                                   "roofline_share",
                                   "two_pass_roofline_share")},
            "bound_by": "bytes",
            "per": "fnet_ev's stage-1 norm, N=80 at 64x240x320, "
                   "channels-last, ReLU fused",
            "request_ms": request_ms,
            "request": "the 45 norms of a B=16 bf16 DSEC forward",
            "residual": {
                "launches": counts[knorm.RESIDUAL_NAME],
                "launches_eval": eval_counts[knorm.RESIDUAL_NAME],
                "equal_to_eager": all(r["equal"] for r in recs
                                      if r.get("residual")),
                **{k: res[k] for k in ("ms", "eager_ms", "plain_ms",
                                       "bound_ms", "bytes_per_element",
                                       "roofline_share")},
                "per": "fnet_ev's stage-1 norm with the block's epilogue"},
            "f32": {
                "max_err_ulps_of_max": max((r["err_ulps_of_max"]
                                            for r in f32_recs), default=None),
                "timed": [{k: r[k] for k in (
                    "layout", "epilogue", "ms", "eager_ms", "bound_ms",
                    "bound_moved_ms", "bound_three_pass_ms",
                    "roofline_share", "roofline_share_moved",
                    "roofline_share_three_pass")}
                    for r in f32_recs if "ms" in r],
                "per": "fnet_ev's stage-1 norm in the DSEC f32 cell, N=40 "
                       "at 64x240x320"}}


# ---------------------------------------------------------------------------
# phase 3e: the convc1 kernel against its plain version

# the map's channels K: DSEC E_I (11 lookup slots of 81), MultiFlow E_I (12),
# DSEC events-only (7)
PROJ_K = [(891, "DSEC E_I"), (972, "MultiFlow E_I"),
          (567, "DSEC events-only")]
# the map's rows M: the bf16 DSEC cell's B=16 (16 x 60 x 80), B=1, the
# streaming window (32 x 40), and one that no 128-row tile divides
PROJ_M = [76800, 4800, 1280, 1000]
PROJ_TIMED_K = 891
# the kernel against the exact result of its function (f64 sums of the
# bf16-rounded operands and the f32 bias, ReLU, rounded once to bf16): every
# output within one bf16 ulp of it, or, near 0, where an ulp is smaller than
# the f32 sums' round-off, within PROJ_ATOL or the bound on K f32 additions
# that each lose at most one unit in the last place, K 2^-23 sum_k |x_k w_k|
# (the tensor cores' f32 accumulation is not the CUDA cores' rounding to
# nearest); at most PROJ_ULP_SHARE of the outputs one ulp off the plain
# version (the eager f32 chain, whose sums run in another order)
PROJ_ULP_SHARE = 5e-3
PROJ_ATOL = 1e-5


def proj_inputs(m, k, seed, device="cuda"):
    """x (M, K) bf16 ~ 2 N(0, 1), about the lookups' spread; convc1's
    weight (256, K, 1, 1) f32 as the model draws it (He with fan-out) and
    a uniform bias (+-1/sqrt(K)): about half the outputs are ReLU's zeros."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2.0 * torch.randn(m, k, generator=gen, device=device)).bfloat16()
    w = torch.randn(kproj.O, k, 1, 1, generator=gen, device=device) * (
        2.0 / kproj.O) ** 0.5
    b = (2.0 * torch.rand(kproj.O, generator=gen, device=device) - 1.0) / (
        k ** 0.5)
    return x, w, b


def proj_bytes(m, k) -> int:
    """The roofline's bytes: the map and the weight read once (bf16), the
    f32 bias, the bf16 output written once."""
    return 2 * m * k + 2 * kproj.O * k + 4 * kproj.O + 2 * m * kproj.O


def exact_corr_proj(x, w, b):
    """The kernel's function with exact sums: the bf16-rounded operands
    multiplied and summed in f64 with the f32 bias, the ReLU, one rounding
    to bf16; and beside it each output's f32 round-off bound (the comment
    of PROJ_ATOL), f32."""
    w2 = w.reshape(w.shape[0], -1).bfloat16().double()
    x2 = x.bfloat16().double()
    y = torch.addmm(b.double(), x2, w2.t())
    bound = x2.abs() @ w2.abs().t() * (x.shape[1] * 2.0 ** -23)
    return F.relu(y).bfloat16(), bound.float().clamp(min=PROJ_ATOL)


def check_corr_proj(m, k, seed, timing=False):
    """The convc1 kernel on the card against the exact result of its
    function (exact_corr_proj): every bf16 output within one ulp (or
    PROJ_ATOL of an output near 0), ReLU's zeros where the exact ones are
    (or within PROJ_ATOL), nothing negative; the plain version (the eager
    f32 chain under full f32) held to the same, and at most PROJ_ULP_SHARE
    of the kernel's outputs one ulp off it; a second launch bit-equal; one
    launch counted a call. With timing: the kernel's ms (L2 flushed before
    each launch) beside its byte and operation bounds, the plain version's
    ms, the f32 torch.addmm the eager chain calls (``library_ms``, its f32
    operands made outside the timing) and a bf16 torch.mm of the same
    operands (``bf16_mm_ms``), neither of which the port calls now."""
    from bflow_tpu_torch.utils.precision import full_f32

    x, w, b = proj_inputs(m, k, seed)
    before = kproj.launches
    got = kproj.corr_proj(x, w, b)
    again = kproj.corr_proj(x, w, b)
    torch.cuda.synchronize()
    launches = kproj.launches - before
    with full_f32():
        want = kproj.corr_proj_plain(x, w, b)
    exact, tol = exact_corr_proj(x, w, b)

    def beyond(v, atol):  # ulps from the exact result where beyond atol
        near = (v.float() - exact.float()).abs() <= atol
        return bf16_ulps(v, exact).masked_fill(near, 0), near

    ulps, near = beyond(got, tol)
    plain_ulps, _ = beyond(want, tol)
    zeros_apart = ((got == 0) != (exact == 0)) & ~near
    vs_plain = bf16_ulps(got, want)
    rec = {"m": m, "k": k,
           "max_ulps_beyond_atol": int(ulps.max().item()),
           "plain_max_ulps_beyond_atol": int(plain_ulps.max().item()),
           # outputs more than one ulp and PROJ_ATOL from the exact result
           "beyond_ulp_and_atol": int((beyond(got, PROJ_ATOL)[0] > 1).sum()),
           "plain_beyond_ulp_and_atol": int(
               (beyond(want, PROJ_ATOL)[0] > 1).sum()),
           "max_tol": tol.max().item(),
           "max_abs_err": (got.float() - exact.float()).abs().max().item(),
           "share_off_by_one_ulp": (vs_plain == 1).float().mean().item(),
           "max_ulps_vs_plain": int(vs_plain.max().item()),
           "share_relu_zeros": (exact == 0).float().mean().item(),
           "relu_zeros_apart": int(zeros_apart.sum().item()),
           "min_output": got.float().min().item(),
           "bitwise_repeatable": torch.equal(got, again),
           "launches_per_call": launches / 2,
           "ulp_share_bound": PROJ_ULP_SHARE, "atol": PROJ_ATOL}
    rec["ok"] = (rec["max_ulps_beyond_atol"] <= 1
                 and rec["plain_max_ulps_beyond_atol"] <= 1
                 and rec["share_off_by_one_ulp"] <= PROJ_ULP_SHARE
                 and rec["relu_zeros_apart"] == 0 and rec["min_output"] >= 0
                 and rec["bitwise_repeatable"] and launches == 2)
    if not timing:
        return rec
    del got, again, want, exact, tol, ulps, near, plain_ulps, zeros_apart
    del vs_plain
    xf = x.float()
    wf = w.reshape(kproj.O, k).bfloat16().float().t()
    wb = w.reshape(kproj.O, k).bfloat16().t()

    def plain():
        with full_f32():
            return kproj.corr_proj_plain(x, w, b)

    def library():
        with full_f32():
            return torch.addmm(b, xf, wf)

    nbytes = proj_bytes(m, k)
    flops = 2 * m * k * kproj.O
    rec.update(bytes=nbytes, flops=flops,
               ms=time_ms(lambda: kproj.corr_proj(x, w, b)),
               plain_ms=time_ms(plain), library_ms=time_ms(library),
               bf16_mm_ms=time_ms(lambda: torch.mm(x, wb)),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               flops_bound_ms=flops / BF16_FLOPS * 1e3, bound_by="bytes")
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def proj_phase(seed: int, timing: bool = True):
    """Phase 3e: the convc1 kernel at each map width of PROJ_K and each
    row count of PROJ_M, timed at DSEC E_I's width for the three model
    shapes. Returns the records and the kernel's device ms a B=16 request
    (12 launches)."""
    recs, request_ms = [], None
    for i, (k, what) in enumerate(PROJ_K):
        for j, m in enumerate(PROJ_M):
            rec = check_corr_proj(m, k, seed + 4 * i + j, timing=timing and (
                k == PROJ_TIMED_K and m != PROJ_M[-1]))
            rec["width"] = what
            emit("kernel", name=kproj.NAME, **rec)
            check(rec["ok"], f"convc1 kernel disagrees: {rec}")
            recs.append(rec)
            if "ms" in rec and m == PROJ_M[0]:
                request_ms = ITERS * rec["ms"]
    return recs, request_ms


def proj_summary(recs, request_ms, counts, eval_counts):
    """The convc1 kernel's entry of the kernels line: DSEC E_I at B=16
    (M = 76,800, K = 891) and the request's 12 launches; launches in phase
    4's forwards and phase 7d's val run."""
    top = next(r for r in recs if r["m"] == PROJ_M[0]
               and r["k"] == PROJ_TIMED_K)
    return {"name": kproj.NAME, "route": "cuda",
            "source": "bflow_tpu_torch/csrc/corr_proj.cu",
            "replaces": "none: XLA runs the JAX package's fused convc1 "
                        "einsum (bflow_tpu/models/update.py)",
            "launches": counts[kproj.NAME],
            "launches_eval": eval_counts[kproj.NAME],
            "max_ulps_beyond_atol": max(r["max_ulps_beyond_atol"]
                                        for r in recs),
            **{k: top.get(k) for k in ("ms", "plain_ms", "library_ms",
                                       "bf16_mm_ms", "bound_ms",
                                       "flops_bound_ms", "roofline_share")},
            "bound_by": "bytes",
            "per": "launch, M=76,800 (B=16 at 60x80), K=891",
            "request_ms": request_ms,
            "request": "the 12 launches of a B=16 bf16 DSEC forward"}


# ---------------------------------------------------------------------------
# phase 7: the DSEC evaluation path through the port's own entry points


EVAL_WINDOWS, EVAL_TEST_WINDOWS, EVAL_BATCH = 9, 4, 4
EVENTS_PER_WINDOW = 1_000_000
DSEC_EXPERIMENT = "+experiment/dsec/raft_spline=E_I_LU4_BD2_lowpyramid"
# the flagship's overrides: 15 bins, bf16 correlation and compute
# (fuse_corr_conv and 12 iterations are the config's defaults, the
# correlation bins come from the data)
FLAGSHIP_BINS = ["model.num_bins.context=15"]
FLAGSHIP_OVERRIDES = FLAGSHIP_BINS + ["model.precision.corr=bfloat16",
                                      "model.precision.compute=bfloat16"]
OPT_IN_OVERRIDES = ["model.lookup_method=pallas_q8", "model.pallas_stem=true",
                    "model.pallas_conv=true"]


def write_png(path, img) -> None:
    import cv2

    check(cv2.imwrite(str(path), np.ascontiguousarray(img[..., ::-1])),
          f"cv2 could not write {path}")  # cv2 takes BGR


def write_dsec_recording(seq, n_flows: int, seed: int, with_flow: bool,
                         events_per_window: int = EVENTS_PER_WINDOW,
                         h: int = H, w: int = W) -> dict:
    """One recording in the DSEC directory contract (the data layer's, as
    tests/fixtures.py:make_dsec_sequence writes it), through the port's
    own HDF5 writer where h5py is missing: n_flows 100 ms flow windows
    from 100 ms after the recording's start, events uniform over the span
    with a window of margin at each end, a sub-pixel rectify map,
    boundary frames, and flow ground truth (16-bit PNGs) where with_flow.
    Returns the events and bytes written."""
    from bflow_tpu_torch.data import hdf5

    rng = np.random.default_rng(seed)
    ev_dir = seq / "events" / "left"
    ev_dir.mkdir(parents=True)
    (seq / "flow").mkdir()
    t_offset, step = 10_000_000, 100_000
    starts = t_offset + step * np.arange(1, n_flows + 1, dtype=np.int64)
    np.savetxt(seq / "flow" / "forward_timestamps.txt",
               np.stack([starts, starts + step], axis=1), fmt="%d",
               delimiter=",")
    if with_flow:
        (seq / "flow" / "forward").mkdir()
        for i in range(n_flows):
            flow = rng.uniform(-8, 8, (h, w, 2))
            valid = rng.random((h, w)) > 0.2
            enc = np.zeros((h, w, 3), np.uint16)
            enc[..., :2] = np.where(valid[..., None],
                                    np.clip(flow * 128 + 2**15, 0, 2**16 - 1),
                                    2**15)
            enc[..., 2] = valid
            write_png(seq / "flow" / "forward" / f"{2 * i:06d}.png", enc)
    n_events = events_per_window * (n_flows + 2)
    span = step * (n_flows + 2)
    t_rel = np.sort(rng.integers(0, span, n_events)).astype(np.uint32)
    hdf5.write_arrays(ev_dir / "events.h5", {
        "events/t": t_rel,
        "events/x": rng.integers(0, w, n_events).astype(np.uint16),
        "events/y": rng.integers(0, h, n_events).astype(np.uint16),
        "events/p": rng.integers(0, 2, n_events).astype(np.uint8),
        "ms_to_idx": np.searchsorted(
            t_rel, 1000 * np.arange(span // 1000 + 200, dtype=np.int64)),
        "t_offset": np.int64(t_offset)})
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    rect = np.stack([gx, gy], axis=-1).astype(np.float32)
    rect += rng.uniform(-0.4, 0.4, rect.shape).astype(np.float32)
    rect[..., 0] = np.clip(rect[..., 0], 0, w - 1)
    rect[..., 1] = np.clip(rect[..., 1], 0, h - 1)
    hdf5.write_arrays(ev_dir / "rectify_map.h5", {"rectify_map": rect})
    img_dir = seq / "images" / "left" / "ev_inf"
    img_dir.mkdir(parents=True)
    for i in range(n_flows + 2):
        write_png(img_dir / f"{2 * i:06d}.png",
                  rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return {"events": n_events, "events_per_window": events_per_window,
            "bytes": sum(p.stat().st_size for p in seq.rglob("*")
                         if p.is_file())}


def eval_voxelize(seq, nbins: int, device="cuda", h: int = H, w: int = W):
    """Phase 7b: one window's events from the port's EventSlicer, the
    rectified (float) ones and the raw (integer) ones, through the host
    rasterizer and the device one; the device gets window-relative times
    (ops/voxelize.py: t is cast to f32 before t0 is subtracted)."""
    from bflow_tpu_torch.data import hdf5
    from bflow_tpu_torch.data.eventslicer import EventSlicer
    from bflow_tpu_torch.data.representations import VoxelGrid
    from bflow_tpu_torch.ops.voxelize import voxelize_events

    ts = np.loadtxt(seq / "flow" / "forward_timestamps.txt", dtype=np.int64,
                    delimiter=",", ndmin=2)
    t0c, t1c = (int(v) for v in ts[1])
    grid = VoxelGrid(nbins, h, w)
    lo, hi = grid.get_extended_time_window(t0c, t1c)
    ev_dir = seq / "events" / "left"
    with hdf5.open_file(ev_dir / "events.h5") as f:
        ev = EventSlicer(f).get_events(lo, hi)
    with hdf5.open_file(ev_dir / "rectify_map.h5") as f:
        rect = np.asarray(f["rectify_map"])
    x, y, p, t = ev["x"], ev["y"], ev["p"], ev["t"].astype(np.int64)
    xy = rect[y, x]
    rec = {"events": int(t.size), "window_us": [lo, hi], "bound": 1e-4}
    for name, xs, ys in (("rectified", xy[:, 0], xy[:, 1]),
                         ("raw", x.astype(np.int64), y.astype(np.int64))):
        host_args = (xs, ys, p.astype(np.float32), t, t0c, t1c)
        t0 = time.perf_counter()
        want = grid.convert(*host_args)
        host_ms = (time.perf_counter() - t0) * 1e3
        # the same window four times on four threads (the Loader's
        # workers): the wall says how much of the host rasterizer runs
        # outside the GIL
        with ThreadPoolExecutor(4) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda _: grid.convert(*host_args), range(4)))
            host4_ms = (time.perf_counter() - t0) * 1e3
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (xs, ys, p, t - t0c)]
        valid = torch.ones(t.size, dtype=torch.bool, device=device)

        def fn():
            return voxelize_events(*args, valid, 0, t1c - t0c,
                                   channels=nbins, height=h, width=w)

        got = fn()
        again = fn()
        err = (got.permute(2, 0, 1).cpu()
               - torch.from_numpy(want)).abs().max().item()
        dev_ms = time_ms(fn, reps=10, warmup=1)
        rec[name] = {"max_abs_err": err,
                     "repeat_max_abs_diff": (again - got).abs().max().item(),
                     "host_ms": host_ms, "host_ms_4_on_4_threads": host4_ms,
                     "device_ms": dev_ms,
                     "events_per_s": t.size / (dev_ms / 1e3)}
        check(err <= 1e-4, f"device voxelizer, {name} events: max |device - "
                           f"host| {err} > 1e-4")
    return rec


def read_val_csv(path) -> dict:
    import csv

    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    check(len(rows) == 1, f"{path}: {len(rows)} rows")
    return {k: float(v) for k, v in rows[0].items()}


def val_args(root, ckpt, batch, cache: bool, extra=(), h=H, w=W,
             bf16: bool = True):
    """The CLI overrides of phase 7 (DSEC's size needs none); without
    bf16, no model.precision.* override: the config's own f32 (phase
    12)."""
    size = [] if (h, w) == (H, W) else [f"dataset.height={h}",
                                        f"dataset.width={w}"]
    return ["dataset=dsec", "model=raft-spline", f"dataset.path={root}",
            f"checkpoint={ckpt}", DSEC_EXPERIMENT,
            *(FLAGSHIP_OVERRIDES if bf16 else FLAGSHIP_BINS),
            f"batch_size={batch}", "hardware.num_workers=4",
            f"dataset.load_voxel_grid={str(cache).lower()}", *size, *extra]


def val_run(args, workdir, device="cuda"):
    """bflow_tpu_torch.val.main once in workdir, launch counts reset just
    before and read just after; its CSV read back."""
    import os

    from bflow_tpu_torch import val

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        kernels.reset_launch_counts()
        out = val.main(args, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        os.chdir(cwd)
    csv_metrics = read_val_csv(workdir / "validation_logs" / "val_metrics.csv")
    return out, counts, csv_metrics


def batch_sizes(n: int, b: int):
    return [min(b, n - i) for i in range(0, n, b)]


def plain_twin_metrics(args, ckpt, device="cuda"):
    """The val/* metrics of make_eval_step over the same batches (the
    task val.main builds: DSEC, or MultiFlow at its supervision times),
    every kernel swapped for its plain twin (plain_twins)."""
    from bflow_tpu_torch.cli import (CONFIG_DIR, backfill_correlation_bins,
                                     build_provider, model_config_from,
                                     supervision_timestamps)
    from bflow_tpu_torch.confsys import compose
    from bflow_tpu_torch.data.loader import Loader
    from bflow_tpu_torch.train import TaskConfig, make_eval_step
    from bflow_tpu_torch.train.checkpoint import restore_weights_only
    from bflow_tpu_torch.utils.metrics import MetricBank

    config = compose(CONFIG_DIR, "val", args)
    provider = build_provider(config)
    backfill_correlation_bins(config, provider)
    model = bt.RAFTSpline(model_config_from(config))
    restore_weights_only(ckpt, model)
    model = model.to(device).eval()
    val_ds = provider.get_val_dataset()
    task = (TaskConfig("multiflow2d", supervision_timestamps=(
        supervision_timestamps(val_ds)))
        if config["dataset"]["name"] == "multiflow_regen"
        else TaskConfig("dsec"))
    step = make_eval_step(model, task)
    loader = Loader(val_ds, int(config["batch_size"]), num_workers=4,
                    drop_last=False, device=device)
    bank = MetricBank()
    with plain_twins():
        for batch in loader:
            bank.update(step(batch)[0])
    return bank.compute()


def dsec_setup(workdir, seed: int, device="cuda", h: int = H, w: int = W,
               events_per_window: int = EVENTS_PER_WINDOW):
    """Phase 7a: fabricated DSEC recordings under workdir/dsec (a train
    recording of EVAL_WINDOWS windows with flow, a test recording of
    EVAL_TEST_WINDOWS) and a port checkpoint of the flagship's seeded
    weights with the damped head; written once per workdir. Returns the
    data root and the checkpoint."""
    from bflow_tpu_torch.data import hdf5
    from bflow_tpu_torch.data import io as dio

    root = workdir / "dsec"
    ckpt = workdir / "flagship_damped.pt"
    if not root.exists():
        t0 = time.perf_counter()
        wrote = {"train": write_dsec_recording(
            root / "train" / "zurich_city_00_a", EVAL_WINDOWS, seed, True,
            events_per_window, h, w),
            "test": write_dsec_recording(
            root / "test" / "interlaken_00_b", EVAL_TEST_WINDOWS, seed + 1,
            False, events_per_window, h, w)}
        emit("eval_data", height=h, width=w, windows={
            "train": EVAL_WINDOWS, "test": EVAL_TEST_WINDOWS}, **wrote,
            seconds=time.perf_counter() - t0,
            hdf5=("h5py" if hdf5.h5py is not None
                  else "bflow_tpu_torch builtin"),
            cache_codec=dio.cache_codec())
    if not ckpt.exists():
        model = damp_head(bt.build_model(bt.flagship_config(), device=device,
                                         seed=seed))
        torch.save({"model": model.state_dict()}, ckpt)
        del model
    return root, ckpt


def predict_run(sub, root, ckpt, cfg, h: int = H, w: int = W, bf16=True,
                plain=False, device="cuda") -> dict:
    """predict_dsec.main on the test recording into sub, launch counts
    reset just before and read just after; its PNGs against the test_mode
    forward of cfg from ckpt on the same items, within 1/128 px (the PNG
    truncates to 1/128); ITERS lookup launches per window. plain: that
    forward also against the same forward with every kernel through its
    plain twin and TF32 off, within F32_EVAL_TOL of the twins' largest
    flow (the f32 norm kernel sums its statistics in another order than
    its twin, so the two differ by round-off the recurrence carries)."""
    from bflow_tpu_torch import predict_dsec
    from bflow_tpu_torch.data.dsec.provider import DsecProvider
    from bflow_tpu_torch.data.io import load_flow_png
    from bflow_tpu_torch.data.keys import DataLoading as K
    from bflow_tpu_torch.train.checkpoint import restore_weights_only

    kernels.reset_launch_counts()
    out = predict_dsec.main(
        [a for a in val_args(root, ckpt, 1, True, (), h, w, bf16)
         if not a.startswith(("dataset=", "model=", "batch_size"))]
        + [f"output_dir={sub}"], device=device)
    counts = kernels.launch_counts()
    pngs = sorted(sub.glob("*/*.png"))
    check(len(pngs) == EVAL_TEST_WINDOWS
          and {p.parent.name for p in pngs} == {"interlaken_00_b"},
          f"predict_dsec wrote {pngs}")
    model = bt.RAFTSpline(cfg)
    restore_weights_only(ckpt, model)
    model = model.to(device).eval()
    provider = DsecProvider({"path": str(root), "load_voxel_grid": True,
                             "extended_voxel_grid": True,
                             "normalize_voxel_grid": True,
                             "height": h, "width": w}, cfg.nbins_context)
    (seq, test_ds), = provider.iter_test_sequences()
    worst, twin_rel = 0.0, 0.0
    for i in range(len(test_ds)):
        item = test_ds[i]
        voxel = torch.from_numpy(item[K.EV_REPR.value])[None].to(device)
        images = torch.from_numpy(item[K.IMG.value])[:, None].to(device)
        _, up = model(voxel, images, test_mode=True)
        flow = up.flow_at(1.0)[0].float().cpu().numpy()
        if plain:
            with plain_twins(), tf32(False):
                _, up = model(voxel, images, test_mode=True)
            twin = up.flow_at(1.0)[0].float().cpu().numpy()
            twin_rel = max(twin_rel, float(np.abs(flow - twin).max()
                                           / np.abs(twin).max()))
        dec, valid = load_flow_png(
            sub / seq / f"{int(item[K.FILE_INDEX.value]):06d}.png")
        check(dec.shape == (h, w, 2) and bool(valid.all()),
              f"PNG {i}: shape {dec.shape}, valid {valid.mean()}")
        worst = max(worst, float(np.abs(dec - flow).max()))
    check(worst <= 1 / 128, f"predict_dsec PNGs vs the eval forward: {worst}")
    check(counts[klookup.NAME] == ITERS * EVAL_TEST_WINDOWS,
          f"predict_dsec launches {counts}")
    rec = {"pngs": len(pngs), "seconds": out["seconds"], "launches": counts,
           "max_abs_vs_eval_forward_px": worst, "bound_px": 1 / 128}
    if plain:
        check(twin_rel <= F32_EVAL_TOL,
              f"predict_dsec's forward vs the plain twins: {twin_rel}")
        rec.update(rel_vs_plain_twins=twin_rel, twin_bound=F32_EVAL_TOL)
    return rec


def eval_phase(workdir, seed: int, device="cuda", h: int = H, w: int = W,
               events_per_window: int = EVENTS_PER_WINDOW):
    """Phase 7: fabricate DSEC recordings (7a), the device voxelizer
    against the host one (7b), val on the default path, uncached, writing
    the voxel caches and reading them (7c), val with the opt-in modes
    (7d), predict_dsec on the test recording (7e). Returns the launch
    counts of 7c's first run and of 7d, for the kernels line."""
    t_phase = time.perf_counter()
    root, ckpt = dsec_setup(workdir, seed, device, h, w, events_per_window)
    train_seq = root / "train" / "zurich_city_00_a"

    # 7b. the device voxelizer
    cfg = bt.flagship_config()
    rec = eval_voxelize(train_seq, cfg.nbins_context, device, h, w)
    emit("eval_voxelize", **rec)

    # 7c. val, default modes: uncached, writing the caches, reading them
    sizes = batch_sizes(EVAL_WINDOWS, EVAL_BATCH)
    want = dict.fromkeys(kernels.KERNELS, 0)
    for n in sizes:
        for k, v in expected_launches(cfg, n, h, w).items():
            want[k] += v
    runs, csvs = {}, {}
    for name, cache in (("uncached", False), ("cache_writing", True),
                        ("cached", True)):
        out, counts, csvs[name] = val_run(
            val_args(root, ckpt, EVAL_BATCH, cache, (), h, w), workdir, device)
        runs[name] = {"fields": out["fields"], "seconds": out["seconds"],
                      "loader_wait_share": out["loader_wait_share"],
                      "launches": counts,
                      "launches_per_forward": {
                          k: v / len(sizes) for k, v in counts.items()}}
        check(out["model_config"] == cfg,
              f"val built {out['model_config']}, not flagship_config()")
        check(out["fields"] == EVAL_WINDOWS, f"val saw {out['fields']}")
        check(counts == want, f"val {name}: launches {counts}, derived "
                              f"{want} over batches {sizes}")
    metrics = {k: v for k, v in csvs["uncached"].items()
               if k.startswith("val/")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()),
          f"val metrics {metrics}")
    for name in ("cache_writing", "cached"):
        other = {k: csvs[name][k] for k in metrics}
        check(other == metrics, f"val {name} {other} != uncached {metrics}")
    caches = sorted(train_seq.glob("events/left/voxel_grids_*/*.h5"))
    check(len(caches) == EVAL_WINDOWS + 1, f"{len(caches)} cache files")
    plain = plain_twin_metrics(val_args(root, ckpt, EVAL_BATCH, True, (), h, w), ckpt,
                               device)
    rel = {k: abs(metrics[k] - plain[k]) / max(abs(plain[k]), 1e-6)
           for k in metrics}
    emit("eval_val", config="flagship E_I_LU4_BD2 bf16 fuse_corr_conv "
                            "(config composed by val, == flagship_config())",
         batch=EVAL_BATCH, batches=sizes, height=h, width=w,
         runs=runs, metrics=metrics, plain_twin_metrics=plain,
         rel_diff_vs_plain=rel, bound=5e-2, cache_files=len(caches),
         launches_derived=want)
    check(all(v < 5e-2 for v in rel.values()),
          f"val metrics vs plain twins: {rel}")

    # 7d. val with the opt-in modes: every window in one batch
    opt_cfg = opt_in_config()
    out, opt_counts, opt_csv = val_run(
        val_args(root, ckpt, EVAL_WINDOWS, True, OPT_IN_OVERRIDES, h, w), workdir,
        device)
    want_opt = expected_launches(opt_cfg, EVAL_WINDOWS, h, w)
    emit("eval_val_opt_in", batch=EVAL_WINDOWS, fields=out["fields"],
         loader_wait_share=out["loader_wait_share"],
         launches=opt_counts, launches_derived=want_opt,
         metrics={k: v for k, v in opt_csv.items() if k.startswith("val/")})
    check(out["model_config"] == opt_cfg, f"opt-in val built "
                                          f"{out['model_config']}")
    check(opt_counts == want_opt, f"opt-in val launches {opt_counts}, "
                                  f"derived {want_opt}")
    check(all(np.isfinite(v) for k, v in opt_csv.items()
              if k.startswith("val/")), f"opt-in val metrics {opt_csv}")

    # 7e. predict_dsec on the test recording, against the eval forward
    rec = predict_run(workdir / "submission", root, ckpt, cfg, h, w,
                      device=device)
    emit("eval_predict", **rec)
    emit("eval_phase", seconds=time.perf_counter() - t_phase)
    return runs["uncached"]["launches"], opt_counts


# ---------------------------------------------------------------------------
# phase 9: MultiFlow training through the port's own training CLI


MF_EXPERIMENT = "+experiment/multiflow/raft_spline=E_I_LU5_BD10_lowpyramid"
MF_H, MF_W = 384, 512  # MultiFlow2D's native frames
MF_CROP = (368, 496)  # its training crop
MF_TRAIN, MF_VAL, MF_BATCH = 6, 3, 3
MF_EVENTS = 1_000_000
# the experiment's lookup table: event targets 8..40 at depths 1,1,1,1,4
# and the frame at depth 4, so 6 base targets and 6 + 2 + 2 + 2 slots
MF_PYRAMID_TARGETS = [(0, 1, 2, 3, 4, 5), (4, 5), (4, 5), (4, 5)]
MF_TRAINING = {"learning_rate": 1e-4, "weight_decay": 1e-4,
               "gradient_clip_val": 1,
               "lr_scheduler": {"use": True, "total_steps": 6,
                                "pct_start": 0.01}}


def write_multiflow_sample(sample, seed: int, n_events: int = MF_EVENTS,
                           h: int = MF_H, w: int = MF_W) -> int:
    """One sample in MultiFlow2D's directory contract (the data layer's,
    as tests/fixtures.py:make_multiflow_sample writes it), through the
    port's own HDF5 writer where h5py is missing: events uniform in x, y
    and t over [0, 1e6) us, random flow every 50 ms from 450 to 900 ms,
    boundary frames at 400 and 900 ms. Returns the bytes written."""
    from bflow_tpu_torch.data import hdf5

    rng = np.random.default_rng(seed)
    for d in ("events", "flow", "images"):
        (sample / d).mkdir(parents=True)
    hdf5.write_arrays(sample / "events" / "events.h5", {
        "t": np.sort(rng.integers(0, 1_000_000, n_events)).astype(np.uint32),
        "x": rng.integers(0, w, n_events).astype(np.uint16),
        "y": rng.integers(0, h, n_events).astype(np.uint16),
        "p": rng.integers(0, 2, n_events).astype(np.uint8)})
    for ts in range(450_000, 900_001, 50_000):
        hdf5.write_arrays(sample / "flow" / f"{ts:07d}.h5", {
            "flow": rng.uniform(-6, 6, (h, w, 2)).astype(np.float32)})
    for ts in (400_000, 900_000):
        write_png(sample / "images" / f"{ts:07d}.png",
                  rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return sum(p.stat().st_size for p in sample.rglob("*") if p.is_file())


def with_overrides(args, extra):
    """args with the keys of `extra` replaced by extra's values."""
    keys = {e.split("=", 1)[0] for e in extra}
    return [a for a in args if a.split("=", 1)[0] not in keys] + list(extra)


def mf_train_args(root, out, ckpt, extra=()):
    """The CLI overrides of phase 9: the experiment at full width, batch
    3, two epochs of two batches, validation over the val split each
    epoch, logs and media every step, from a port checkpoint's weights."""
    return with_overrides(
        ["dataset=multiflow_regen", "model=raft-spline",
         f"dataset.path={root}", "wandb.group_name=smoke", MF_EXPERIMENT,
         f"training.batch_size={MF_BATCH}", "training.max_epochs=2",
         "training.max_steps=6", "training.limit_train_batches=2",
         "training.limit_val_batches=1.0", "logging.log_every_n_steps=1",
         f"logging.out_dir={out}", f"wandb.artifact_name={ckpt}",
         "wandb.resume_only_weights=true"], extra)


class media_capture:
    """Within the block, what the media callbacks hand the W&B logger
    (a no-op here: WANDB_MODE=disabled) is recorded: key, step, shape,
    type and value range."""

    def __enter__(self):
        from bflow_tpu_torch.loggers.wandb_logger import WandbLogger

        self.images, self._cls = [], WandbLogger
        self._saved = WandbLogger.log_image

        def log_image(logger, key, image, step, caption=""):
            img = np.asarray(image)
            self.images.append({"key": key, "step": step,
                                "shape": list(img.shape),
                                "dtype": str(img.dtype),
                                "range": [int(img.min()), int(img.max())]})
            self._saved(logger, key, image, step, caption)

        WandbLogger.log_image = log_image
        return self

    def __exit__(self, *exc):
        self._cls.log_image = self._saved


def train_cli_run(args, device="cuda", backend=None, timeout_s=None):
    """bflow_tpu_torch.train.loop.main once, launch counts reset just
    before and read just after (this process's: spawned ranks count
    their own); its CSV rows read back. ``timeout_s`` bounds ranks the
    loop spawns."""
    from bflow_tpu_torch.train import loop

    kernels.reset_launch_counts()
    out = loop.main(args, device=device, backend=backend,
                    timeout_s=timeout_s)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    return out, counts, train_csv_rows(out["run_dir"])


def train_csv_rows(run_dir):
    """A training run's train_metrics.csv as rows of floats."""
    import csv

    with open(run_dir / "train_metrics.csv") as fh:
        return [{k: float(v) for k, v in r.items() if v != ""}
                for r in csv.DictReader(fh)]


def reference_lr(steps):
    """The learning rate after each of `steps` scheduler steps, from a
    fresh optimizer over the phase's training config."""
    from bflow_tpu_torch.train.optimizer import build_optimizer

    opt, sched = build_optimizer(MF_TRAINING, [torch.zeros(1)])
    out = {}
    for k in range(1, max(steps) + 1):
        opt.step()
        sched.step()
        out[k] = opt.param_groups[0]["lr"]
    return {k: out[k] for k in steps}


def bezier_check(seed: int, ts, degree: int = 10):
    """BezierCurves.flow_at at the supervision times on the card, at the
    training crop, against de Casteljau's construction in float64 on the
    host (an independent form of the Bernstein sum)."""
    from bflow_tpu_torch.ops.bezier import BezierCurves

    g = torch.Generator(device="cuda").manual_seed(seed)
    params = torch.randn(MF_BATCH, MF_CROP[0] // 8, MF_CROP[1] // 8, degree,
                         2, generator=g, device="cuda")
    got = BezierCurves(params).flow_at(ts).double().cpu()
    p = params.double().cpu()
    pts = torch.cat([torch.zeros_like(p[..., :1, :]), p], dim=-2)
    want = []
    for t in ts:
        q = pts
        while q.shape[-2] > 1:
            q = (1 - t) * q[..., :-1, :] + t * q[..., 1:, :]
        want.append(q[..., 0, :])
    want = torch.stack(want)
    err = ((got - want).abs().max() / want.abs().max()).item()
    return {"degree": degree, "times": list(ts), "rel_err": err,
            "bound": 1e-5, "ok": err <= 1e-5}


def multiflow_setup(workdir, seed: int, device="cuda"):
    """Phase 9a: fabricated MultiFlow samples under workdir/multiflow and
    a port checkpoint of seeded weights with the damped head (undamped,
    the random-init recurrence diverges over 12 iterations); written once
    per workdir. Returns the data root, the checkpoint and the model
    config the CLI composes."""
    from bflow_tpu_torch.cli import (CONFIG_DIR, backfill_correlation_bins,
                                     build_provider, model_config_from)
    from bflow_tpu_torch.confsys import compose

    root = workdir / "multiflow"
    ckpt = workdir / "multiflow_damped.pt"
    if not root.exists():
        t0 = time.perf_counter()
        nbytes = 0
        for split, n, off in (("train", MF_TRAIN, 0), ("val", MF_VAL, 100)):
            for i in range(n):
                nbytes += write_multiflow_sample(
                    root / split / f"seq_{i:04d}", seed + off + i)
        emit("train_cli_data", samples={"train": MF_TRAIN, "val": MF_VAL},
             events_per_sample=MF_EVENTS, height=MF_H, width=MF_W,
             bytes=nbytes, seconds=time.perf_counter() - t0)
    config = compose(CONFIG_DIR, "train",
                     mf_train_args(root, workdir / "runs", ckpt))
    backfill_correlation_bins(config, build_provider(config))
    cfg = model_config_from(config)
    if not ckpt.exists():
        model = damp_head(bt.build_model(cfg, device=device, seed=seed))
        torch.save({"model": model.state_dict()}, ckpt)
        del model
    return root, ckpt, cfg


def train_phase(workdir, seed: int, device="cuda"):
    """Phase 9: fabricate MultiFlow samples (9a), train through the CLI
    with validation, checkpoints and media (9b), resume (9c), step 1 on
    the plain twins (9d), the lookups at these shapes (9e), the dVol work
    of one train step (9f), the numbers (9g). Returns the CLI run's launch
    counts and the 9e records."""
    t_phase = time.perf_counter()
    root, ckpt, cfg = multiflow_setup(workdir, seed, device)

    # 9b. two epochs of two steps, validation each epoch
    from bflow_tpu_torch.cli import (CONFIG_DIR, build_provider,
                                     supervision_timestamps)
    from bflow_tpu_torch.confsys import compose

    runs = workdir / "runs"
    check((cfg.nbins_context, cfg.nbins_correlation, cfg.bezier_degree,
           cfg.ev_target_indices, cfg.ev_levels, cfg.iters_train,
           cfg.iters_test, cfg.corr_precision, cfg.compute_dtype,
           cfg.use_images)
          == (41, 25, 10, (8, 16, 24, 32, 40), (1, 1, 1, 1, 4), 12, 12,
              "float32", "float32", True),
          f"composed MultiFlow config {cfg}")
    torch.cuda.reset_peak_memory_stats()
    with media_capture() as media:
        out, counts, rows = train_cli_run(mf_train_args(root, runs, ckpt),
                                          device)
    peak = torch.cuda.max_memory_allocated()
    run_dir = out["run_dir"]
    train_rows = [r for r in rows if "train/l1_multi_seq_loss" in r]
    val_rows = [r for r in rows if "val/epe_multi" in r]
    losses = [r["train/l1_multi_seq_loss"] for r in train_rows]
    lrs = {int(r["step"]): r["learning_rate"] for r in train_rows}
    want_lr = reference_lr(range(1, 7))
    steps, logs, val_batches = 4, 4, 2
    want = dict.fromkeys(kernels.KERNELS, 0)
    want[klookup.NAME] = cfg.iters_train * (steps + logs + val_batches)
    want[klookup.BWD_NAME] = cfg.iters_train * steps
    # the media and val forwards (make_eval_step: eval mode, no grad)
    # take the norm kernel at f32; the training steps do not
    want[knorm.NAME] = norm_launches(cfg) * (logs + val_batches)
    want[knorm.RESIDUAL_NAME] = residual_launches(cfg) * (logs + val_batches)
    meta = json.loads((run_dir / "ckpt" / "meta.json").read_text())
    keys = sorted({(m["key"], m["step"]) for m in media.images})
    strips = [m for m in media.images if m["key"] == "train/summary"]
    step_ms = out["step_ms"]
    rec = {
        "config": "MultiFlow E_I_LU5_BD10_lowpyramid, f32, 12 iterations, "
                  "composed by the CLI",
        "batch": MF_BATCH, "crop": list(MF_CROP), "steps": out["step"],
        "losses": losses, "learning_rates": lrs,
        "val_epe_multi": [r["val/epe_multi"] for r in val_rows],
        "val_steps": [int(r["step"]) for r in val_rows],
        "launches": counts, "launches_derived": want,
        "checkpoints": sorted(p.name for p in (run_dir / "ckpt").iterdir()),
        "meta": meta, "media": keys,
        "media_strip_shape": strips[0]["shape"] if strips else None,
        "media_ranges": {m["key"]: m["range"] for m in media.images},
        "train_seconds": out["train_seconds"],
        "log_seconds": out["log_seconds"],
        "samples": out["samples"],
        "loader_wait_share": (out["loader_wait_seconds"]
                              / out["train_seconds"]),
        "device_step_ms": step_ms,
        "device_step_ms_median": statistics.median(step_ms),
        "val_fields": out["val_fields"], "max_memory_allocated": peak}
    emit("train_cli", **rec)
    check(out["step"] == 4 and len(losses) == 4
          and all(np.isfinite(losses)), f"train losses {losses}")
    check(all(abs(lrs[k] - want_lr[k]) <= 1e-12 * want_lr[k]
              for k in range(1, 5)), f"learning rates {lrs} vs {want_lr}")
    check(rec["val_steps"] == [2, 4]
          and all(np.isfinite(rec["val_epe_multi"])),
          f"validation rows {val_rows}")
    check({"best.pt", "last.pt"} <= set(rec["checkpoints"])
          and meta["last_step"] == 4
          and meta["monitor"] == "val/epe_multi",
          f"checkpoints {rec['checkpoints']}, {meta}")
    check(counts == want, f"train CLI launches {counts}, derived {want} "
                          f"({steps} steps, {logs} media forwards, "
                          f"{val_batches} val batches)")
    want_media = ({(k, s) for s in range(1, 5) for k in (
        "train/summary", "train/bezier_trajectories", "train/gradients")}
        | {(k, s) for s in (2, 4) for k in (
            "val/summary_0", "val/bezier_trajectories_0")})
    check(set(keys) == want_media, f"media {keys}")
    check(all(m["dtype"] == "uint8" and m["shape"][-1] == 3
              and m["range"][0] < m["range"][1] for m in media.images),
          f"media images {media.images}")
    check(rec["media_strip_shape"] == [MF_CROP[0], 5 * MF_CROP[1], 3],
          f"summary strip {rec['media_strip_shape']}")
    check(len(step_ms) == 4, f"{len(step_ms)} timed steps")

    # 9c. resume in the same run directory: one more epoch, to step 6
    out_r, counts_r, rows_r = train_cli_run(mf_train_args(
        root, runs, ckpt, ["training.max_epochs=3"]), device)
    lrs_r = {int(r["step"]): r["learning_rate"] for r in rows_r
             if "learning_rate" in r}
    meta_r = json.loads((run_dir / "ckpt" / "meta.json").read_text())
    want_r = dict.fromkeys(kernels.KERNELS, 0)
    want_r[klookup.NAME] = cfg.iters_train * (2 + 2 + 1)
    want_r[klookup.BWD_NAME] = cfg.iters_train * 2
    want_r[knorm.NAME] = norm_launches(cfg) * (2 + 1)
    want_r[knorm.RESIDUAL_NAME] = residual_launches(cfg) * (2 + 1)
    emit("train_cli_resume", steps=out_r["step"], samples=out_r["samples"],
         learning_rates=lrs_r, reference_learning_rates=want_lr,
         losses=[r["train/l1_multi_seq_loss"] for r in rows_r
                 if "train/l1_multi_seq_loss" in r],
         launches=counts_r, launches_derived=want_r, meta=meta_r)
    check(out_r["step"] == 6 and out_r["samples"] == 2 * MF_BATCH
          and sorted(lrs_r) == [5, 6],
          f"resume: step {out_r['step']}, samples {out_r['samples']}, "
          f"logged steps {sorted(lrs_r)}: it did not start at step 4")
    check(all(abs(lrs_r[k] - want_lr[k]) <= 1e-12 * want_lr[k]
              for k in (5, 6)), f"resumed learning rates {lrs_r}")
    check(meta_r["last_step"] == 6 and counts_r == want_r,
          f"resume: {meta_r}, launches {counts_r} vs {want_r}")

    # 9d. step 1 again, every kernel on its plain twin
    with plain_twins():
        _, counts_p, rows_p = train_cli_run(mf_train_args(
            root, workdir / "runs_plain", ckpt,
            ["training.max_epochs=1", "training.limit_train_batches=1",
             "training.limit_val_batches=0", "logging.only_numbers=true"]),
            device)
    loss_p = rows_p[0]["train/l1_multi_seq_loss"]
    rel = abs(losses[0] - loss_p) / abs(loss_p)
    emit("train_cli_plain", loss_kernels=losses[0], loss_plain=loss_p,
         rel=rel, bound=1e-5, launches=counts_p)
    check(rel <= 1e-5, f"step-1 loss vs the plain twins: {rel}")
    check(not any(counts_p.values()), f"plain twins launched {counts_p}")

    # 9e. the lookups at these shapes (f32, B=3 at 368x496: 46x62 queries,
    # maps 46x62 .. 5x7), and degree 10 at the supervision times
    n, h1, w1 = MF_BATCH, MF_CROP[0] // 8, MF_CROP[1] // 8
    fwd = check_lookup_pyramid(n, h1, w1, torch.float32, seed,
                               targets=MF_PYRAMID_TARGETS)
    emit("kernel", name=klookup.NAME, shapes="multiflow", **fwd)
    check(fwd["ok"], f"lookup forward at MultiFlow shapes: {fwd}")
    bwd = check_lookup_pyramid_bwd(n, h1, w1, torch.float32, seed,
                                   targets=MF_PYRAMID_TARGETS)
    emit("kernel", name=klookup.BWD_NAME, shapes="multiflow", **bwd)
    check(bwd["ok"], f"lookup backward at MultiFlow shapes: {bwd}")
    bez = bezier_check(seed, [k / 10 for k in range(1, 11)])
    emit("bezier_degree10", **bez)
    check(bez["ok"], f"degree-10 flow_at vs de Casteljau: {bez}")

    # 9f. one train step at these shapes under the profiler, after one
    # without it: 12 + 12 lookup launches, one dVol zeroing per level, no
    # dVol sum
    from bflow_tpu_torch.data.loader import Loader
    from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step
    from bflow_tpu_torch.train.checkpoint import restore_weights_only

    config = compose(CONFIG_DIR, "train", mf_train_args(root, runs, ckpt))
    provider = build_provider(config)
    train_ds = provider.get_train_dataset()
    batch = next(Loader(train_ds, MF_BATCH, shuffle=True, num_workers=6,
                        device=device).iterate(0, 1))
    model = bt.RAFTSpline(cfg)
    restore_weights_only(ckpt, model)
    state = TrainState.create(model.to(device), MF_TRAINING)
    task = TaskConfig("multiflow2d", multi_loss=True,
                      supervision_timestamps=supervision_timestamps(train_ds))
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    levels = build_corr_pyramid_shapes(cfg, MF_BATCH, *MF_CROP)
    step(batch)
    kernels.reset_launch_counts()
    dvol = dvol_ops(lambda: step(batch), levels)
    step_counts = kernels.launch_counts()
    emit("train_step_dvol", config="multiflow", **dvol, levels=len(levels),
         launches=step_counts)
    check(step_counts[klookup.NAME] == step_counts[klookup.BWD_NAME]
          == cfg.iters_train and dvol["dvol_zero"] == len(levels)
          and dvol["dvol_sum"] == 0,
          f"MultiFlow step: {step_counts} launches, {dvol['dvol_zero']} "
          f"zeroings, {dvol['dvol_sum']} sums")
    del model, state, step, batch

    # 9g. the numbers
    emit("train_phase", seconds=time.perf_counter() - t_phase,
         loader_wait_share=rec["loader_wait_share"],
         log_share=rec["log_seconds"] / rec["train_seconds"],
         device_step_ms_median=rec["device_step_ms_median"],
         max_memory_allocated=peak,
         lookup_ms={"forward": fwd["ms"], "backward": bwd["ms"]},
         x_bound={"forward": fwd["ms"] / fwd["bound_ms"],
                  "backward": bwd["ms"] / bwd["bound_ms"]})
    return counts, fwd, bwd


# ---------------------------------------------------------------------------
# phase 10: data-parallel training (bflow_tpu_torch.parallel)


DIST_B = 6  # 10b's global batch at the training crop: 3 + 3
DIST_SHARES = (0.3, 0.9)  # flow_valid share of rank 0's and rank 1's half
DIST_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5, "metrics": 1e-5}


def dist_batch(seed: int, n: int, device):
    """train_batch's layouts at n samples at the training crop, the first
    half's flow_valid share DIST_SHARES[0] and the second's [1]: a mean
    of the ranks' masked means would differ from the global mean."""
    rng = np.random.default_rng(seed)
    cfg = train_config()
    share = np.repeat(DIST_SHARES, n // 2)[:, None, None]
    b = {
        "ev_repr": rng.standard_normal(
            (n, TRAIN_H, TRAIN_W, cfg.nbins_total)).astype(np.float32),
        "img": rng.integers(0, 255, (2, n, TRAIN_H, TRAIN_W, 3)
                            ).astype(np.float32),
        "flow": (3.0 * rng.standard_normal((n, TRAIN_H, TRAIN_W, 2))
                 ).astype(np.float32),
        "flow_valid": rng.random((n, TRAIN_H, TRAIN_W)) < share,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def dist_step(batch, seed: int, device, timed: int = 2) -> dict:
    """make_train_step from phase 6's weights (seed, damped head) on this
    rank's batch (through DDP, the global BatchNorm, the loss's global
    count and the packed metrics under a process group): the first step's
    loss, metric accumulators, gradients after the reduction (before the
    clamp), cnet's running statistics and lookup launches; then `timed`
    more steps' device ms (CUDA events) and the peak memory."""
    from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step
    from bflow_tpu_torch.train.step import init_metric_acc, train_metric_keys

    model = damp_head(bt.build_model(train_config(), device, seed))
    state = TrainState.create(model, TRAINING)
    task = TaskConfig("dsec")
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    grads = {}
    adam_step = state.optimizer.step

    def keep_grads(*args, **kwargs):  # the clamp works in place
        if not grads:
            grads.update({k: p.grad.detach().clone()
                          for k, p in model.named_parameters()})
        return adam_step(*args, **kwargs)

    state.optimizer.step = keep_grads
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    acc = step(batch, init_metric_acc(train_metric_keys(task), device))
    torch.cuda.synchronize(device)
    counts = kernels.launch_counts()
    stats = {k: v.clone() for k, v in model.cnet.state_dict().items()
             if "running" in k}
    ms = []
    for _ in range(timed):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        step(batch)
        events[1].record()
        torch.cuda.synchronize(device)
        ms.append(events[0].elapsed_time(events[1]))
    total, weight = acc["train/l1_seq_loss"]
    return {"loss": (total / weight).item(),
            "acc": {k: (v.item(), w.item()) for k, (v, w) in acc.items()},
            "grads": {k: g.cpu() for k, g in grads.items()},
            "stats": {k: v.cpu() for k, v in stats.items()},
            "launches": counts, "step_ms": ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}


def dist_compare(got: dict, want: dict) -> dict:
    """got against want: the loss and each metric accumulator relative,
    the gradients against the largest |grad| of the model, cnet's running
    statistics relative to each one's largest."""
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    grad, where = max(((got["grads"][k] - g).abs().max().item() / gmax, k)
                      for k, g in want["grads"].items())
    metrics = max(abs(got["acc"][k][0] - v) / max(abs(v), 1e-12)
                  + (got["acc"][k][1] != w)
                  for k, (v, w) in want["acc"].items())
    out = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "grad": grad, "grad_worst_param": where,
           "stats": max(rel_diff(got["stats"][k], s)
                        for k, s in want["stats"].items()),
           "metrics": metrics}
    out["ok"] = all(out[k] <= DIST_TOL[k] for k in DIST_TOL)
    return out


def _dist_rank(seed: int, device=None, backend=None) -> dict:
    """One of 10b's ranks: its half of the global batch through
    dist_step, then a gradient-sized all-reduce timed; every rank's
    numbers gathered on rank 0."""
    import torch.distributed as dist

    from bflow_tpu_torch.parallel.mesh import shard_batch

    torch.backends.cudnn.deterministic = True
    out = dist_step(shard_batch(dist_batch(seed, DIST_B, device)), seed,
                    device)
    buf = torch.ones(sum(g.numel() for g in out["grads"].values()),
                     device=device)
    times = []
    for _ in range(5):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    mine = {"rank": dist.get_rank(), "step_ms": out["step_ms"],
            "launches": out["launches"],
            "max_memory_allocated": out["max_memory_allocated"],
            "all_reduce_ms": statistics.median(times[1:]),
            "all_reduce_floats": buf.numel()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {**out, "ranks": ranks}


def timed_lines(cmd, timeout_s: float):
    """Run cmd unbuffered in a session of its own; its output lines
    (stdout and stderr merged), each with the seconds from the start at
    which it came, the exit code and the wall seconds. At timeout_s the
    whole session is killed (the launcher and its workers)."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})

    def kill():
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)

    timer = threading.Timer(timeout_s, kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip()))
        rc = proc.wait()
    finally:
        timer.cancel()
        kill()
    return lines, rc, time.perf_counter() - t0


def dist_phase(workdir, seed: int) -> dict:
    """Phase 10: (10a) the DSEC train step over an NCCL group of one rank
    against no group; (10b) two ranks on the one card over gloo, global
    batch 6 with unequal valid shares, against one process at batch 6;
    (10c) the training CLI: under torchrun, with the worker-process loader
    against the threaded one, and over two ranks. Returns 10a's and 10b's
    launch counts."""
    import torch.distributed as dist

    from bflow_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True

    # 10a. world size 1 over NCCL: the phase-6 step through DDP, the global
    # BatchNorm and the packed metrics, against the step without a group
    t0 = time.perf_counter()
    batch = train_batch(seed, dev)
    alone = dist_step(batch, seed, dev)
    distributed.initialize_distributed(
        init_method=f"file://{workdir / 'rendezvous_10a'}", world_size=1,
        rank=0, backend="nccl", device=dev)
    try:
        check(dist.get_backend() == "nccl", "10a: not an NCCL group")
        ranked = dist_step(batch, seed, dev)
    finally:
        dist.destroy_process_group()
    cmp_a = dist_compare(ranked, alone)
    want = {klookup.NAME: ITERS, klookup.BWD_NAME: ITERS}
    launches_a = {k: ranked["launches"][k] for k in want}
    emit("dist_world1", backend="nccl", batch=TRAIN_B, height=TRAIN_H,
         width=TRAIN_W, iters=ITERS, loss=ranked["loss"],
         loss_no_group=alone["loss"], **{f"rel_{k}": v
                                         for k, v in cmp_a.items()},
         bounds=DIST_TOL, launches=ranked["launches"],
         step_ms=ranked["step_ms"], step_ms_no_group=alone["step_ms"],
         max_memory_allocated=ranked["max_memory_allocated"],
         seconds=time.perf_counter() - t0)
    check(cmp_a["ok"], f"10a: one NCCL rank vs no group: {cmp_a}")
    check(launches_a == want, f"10a: launches {ranked['launches']}")
    del batch, alone, ranked

    # 10b. two ranks sharing the card over gloo against one process at the
    # global batch
    t0 = time.perf_counter()
    whole = dist_step(dist_batch(seed, DIST_B, dev), seed, dev)
    torch.cuda.empty_cache()
    t_spawn = time.perf_counter()
    two = distributed.spawn(_dist_rank, 2, args=(seed,), device="cuda:0",
                            backend="gloo", timeout_s=300)
    spawn_s = time.perf_counter() - t_spawn
    cmp_b = dist_compare(two, whole)
    launches_b = [r["launches"] for r in two["ranks"]]
    emit("dist_two_ranks", backend="gloo", device="cuda:0 (both ranks)",
         batch=DIST_B, per_rank=DIST_B // 2, valid_shares=DIST_SHARES,
         height=TRAIN_H, width=TRAIN_W, iters=ITERS, loss=two["loss"],
         loss_one_process=whole["loss"],
         **{f"rel_{k}": v for k, v in cmp_b.items()}, bounds=DIST_TOL,
         ranks=two["ranks"], one_process_step_ms=whole["step_ms"],
         one_process_max_memory_allocated=whole["max_memory_allocated"],
         spawn_and_run_seconds=spawn_s, seconds=time.perf_counter() - t0)
    check(cmp_b["ok"], f"10b: two gloo ranks vs one process: {cmp_b}")
    check(all({k: c[k] for k in want} == want for c in launches_b),
          f"10b: launches per rank {launches_b}")
    del whole, two
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # 10c. the training CLI over ranks, on phase 9's MultiFlow setup: the
    # worker-process loader against the threaded one, in turns, at global
    # batch 2
    root, ckpt, _ = multiflow_setup(workdir, seed)
    quick = ["training.max_steps=2", "training.max_epochs=1",
             "training.limit_train_batches=2", "training.limit_val_batches=0",
             "logging.only_numbers=true"]
    torch.backends.cudnn.deterministic = True
    loaders = {}
    for kind in ("threaded", "grain"):
        t0 = time.perf_counter()
        out, counts, rows = train_cli_run(mf_train_args(
            root, workdir / f"runs_{kind}", ckpt,
            quick + ["training.batch_size=2", f"hardware.loader={kind}"]))
        loaders[kind] = {
            "step1": rows[0], "launches": counts, "samples": out["samples"],
            "samples_per_s": out["samples"] / out["train_seconds"],
            "loader_wait_share": (out["loader_wait_seconds"]
                                  / out["train_seconds"]),
            "seconds": time.perf_counter() - t0}
    torch.backends.cudnn.deterministic = False
    emit("dist_loaders", **loaders)
    step1 = [{k: v for k, v in loaders[kind]["step1"].items()
              if k != "steps_per_sec"} for kind in ("threaded", "grain")]
    check(step1[0] == step1[1],
          f"10c: step 1 of the grain loader {step1[1]} != threaded "
          f"{step1[0]}: the batches differ")

    # python -m torch.distributed.run (one NCCL rank, phase 9's batch 3)
    # beside loop.main over two gloo ranks on the card at global batch 2:
    # neither is timed, so the two share the card and the host's cores
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        torchrun = pool.submit(timed_lines, [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=1", "-m", "bflow_tpu_torch.train",
            *mf_train_args(root, workdir / "runs_torchrun", ckpt, quick)],
            300)
        out, counts, rows = train_cli_run(mf_train_args(
            root, workdir / "runs_two", ckpt,
            quick + ["training.batch_size=2", "hardware.devices=2"]),
            device="cuda:0", backend="gloo", timeout_s=300)
        lines, rc, torchrun_s = torchrun.result()
    both_s = time.perf_counter() - t0
    tr_rows = [] if rc else train_csv_rows(
        workdir / "runs_torchrun" / "smoke_multiflow_regen")
    losses = [r["train/l1_multi_seq_loss"] for r in tr_rows]
    marks = {m: next((t for t, line in lines if line.startswith(m)), None)
             for m in ("training:", "step 1:", "step 2:", "done at")}
    emit("dist_torchrun", returncode=rc, seconds=torchrun_s,
         seconds_to=marks, losses=losses,
         output_tail=[line for _, line in lines[-12:]])
    check(rc == 0 and any(line.startswith("training: 1 rank(s)")
                          for _, line in lines)
          and len(losses) == 2 and all(np.isfinite(losses)),
          f"10c: torchrun run: rc {rc}, losses {losses}")

    run_dir = out["run_dir"]
    files = sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*"))
    loss_one = loaders["threaded"]["step1"]["train/l1_multi_seq_loss"]
    rel = abs(rows[0]["train/l1_multi_seq_loss"] - loss_one) / abs(loss_one)
    emit("dist_cli_two_ranks", backend="gloo", device="cuda:0 (both ranks)",
         world=out["world"], steps=out["step"], samples=out["samples"],
         files=files, loss=rows[0]["train/l1_multi_seq_loss"],
         loss_one_rank=loss_one, rel=rel, bound=1e-5,
         seconds_beside_torchrun=both_s)
    check(out["world"] == 2 and out["step"] == 2 and out["samples"] == 4,
          f"10c: two-rank run {out['world']} ranks, {out['step']} steps")
    check(files == ["ckpt", "ckpt/last.pt", "ckpt/meta.json",
                    "train_metrics.csv"],
          f"10c: two-rank run files {files}")
    check(rel <= 1e-5, f"10c: two-rank step-1 loss vs one rank: {rel}")
    emit("dist_phase", seconds=time.perf_counter() - t_phase)
    return {"world1_nccl": launches_a, "two_ranks_gloo": launches_b}


# ---------------------------------------------------------------------------
# phase 11: streaming inference over raw events (bflow_tpu_torch.streaming)
# and the released-checkpoint tool (bflow_tpu_torch.parity_released)


STREAM_TOL = 5e-2  # the streaming forward (bf16) vs its plain twins
STREAM_WINDOWS = 8  # streaming.main's windows after the first
RELEASED_TOL = 1e-3  # the tool's own PASS threshold
RELEASED_TIMES = (0.5, 1.0)
# each family at the size its dataset delivers: DSEC 480x640 (degree 2),
# MultiFlow 384x512 (degree 10)
RELEASED_SIZE = {2: (480, 640), 10: (384, 512)}


def stream_window(seed: int) -> dict:
    """11a: the streaming window at full width. One window's events
    through the device voxelizer against the host rasterizer (1e-4) and
    through the forward (Bezier head damped) against its plain twins
    (5e-2); then the entry point (streaming.main: a first window and
    STREAM_WINDOWS more), its launches counted, its peak memory."""
    from bflow_tpu_torch import streaming as st
    from bflow_tpu_torch.data.representations import VoxelGrid

    cfg = st.STREAM_CONFIG
    nb, h, w = cfg.nbins_total, st.H, st.W
    events = st.synthetic_events(np.random.default_rng(seed), st.N_EVENTS)
    inputs = st.window_inputs(events, st.EVENT_CAPACITY, "cuda")
    grid = st.window_grid(*inputs, channels=nb, height=h, width=w)
    host = VoxelGrid(nb, h, w).convert(
        *events[:3], events[3].astype(np.int64),
        st.T0 - (st.T1 - st.T0), st.T1)
    grid_err = (grid.permute(2, 0, 1).cpu()
                - torch.from_numpy(host)).abs().max().item()
    check(grid_err <= 1e-4,
          f"11a: device grid vs host VoxelGrid {grid_err} > 1e-4")
    # the Bezier head damped, as in every other comparison with the plain
    # twins: undamped, the random-init recurrence amplifies one bf16 ulp
    # anywhere (the norm kernel's, or the input's) to ~0.3 of the flows
    # within 6 iterations
    model, _ = st.make_pipeline(device="cuda", seed=seed)
    damp_head(model)
    kern = st.grid_flows(model, grid, st.QUERY_TIMES)
    with plain_twins():
        twin = st.grid_flows(model, grid, st.QUERY_TIMES)
    rel = rel_diff(kern, twin)
    check(tuple(kern.shape) == (len(st.QUERY_TIMES), 1, h, w, 2),
          f"11a: flows {tuple(kern.shape)}")
    check(bool(torch.isfinite(kern).all()), "11a: non-finite flows")
    check(rel <= STREAM_TOL, f"11a: kernel path vs plain twins {rel}")

    want = expected_launches(cfg, 1, h, w, cfg.iters_test)
    n_win = 1 + STREAM_WINDOWS
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = st.main(["--windows", str(STREAM_WINDOWS)], device="cuda")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts == {k: v * n_win for k, v in want.items()},
          f"11a: launches over {n_win} windows {counts}, derived per "
          f"window {want}")
    check(run["finite"], "11a: the entry point's flows are not finite")
    return {"events": st.N_EVENTS, "capacity": st.EVENT_CAPACITY,
            "height": h, "width": w, "iters": cfg.iters_test,
            "query_times": list(st.QUERY_TIMES),
            "grid_max_abs_err_vs_host": grid_err, "grid_bound": 1e-4,
            "flows_rel_vs_plain_twins": rel, "tol": STREAM_TOL,
            "launches": counts, "windows_run": n_win,
            "launches_per_window": {k: v / n_win for k, v in counts.items()},
            "max_memory_allocated": peak}


def released_family(workdir, idx: int, name: str, kw: dict) -> dict:
    """11b: one released family through parity_released: its random-init
    export saved as a .ckpt and read back (infer_config must give the
    family), the tool at the family's native size (B=1, 12 iterations,
    f32, then bf16 and pallas_q8) with its launches counted and both TF32
    flags on in the caller (the tool pins full f32 inside its forwards and
    must leave them on), and its f32 flows against the same forward on
    the plain twins."""
    from bflow_tpu_torch import parity_released as pr

    cfg = bt.RaftSplineConfig(**kw)
    path = workdir / f"{name}.ckpt"
    torch.save({"state_dict": pr.random_init_state_dict(cfg, idx)}, path)
    size = RELEASED_SIZE[cfg.bezier_degree]
    modes = (("auto", "float32"), ("auto", "bfloat16"),
             ("pallas_q8", "bfloat16"))  # f32, bf16, q8
    want = {k: sum(expected_launches(
        dataclasses.replace(cfg, lookup_method=m, compute_dtype=p,
                            corr_precision=p), 1, *size, ITERS)[k]
        for m, p in modes) for k in kernels.KERNELS}
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with tf32(True):
        out = pr.main([str(path), "--iters", str(ITERS), "--times",
                       ",".join(map(str, RELEASED_TIMES)), "--size",
                       *map(str, size), "--bf16-also", "--q8-also"],
                      device="cuda")
        flags_after = tf32_state()
    counts = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    check(flags_after == (True, True),
          f"11b {name}: the tool left the caller's TF32 flags at "
          f"{flags_after}")
    check(out["config"] == cfg and out["name"].startswith(name + " "),
          f"11b {name}: infer_config gave {out['name']}")
    check(counts == want, f"11b {name}: launches {counts}, derived {want}")
    for mode, flows in out["flows"].items():
        check(all(np.isfinite(f).all() and f.shape == (1, 2, *size)
                  for f in flows.values()),
              f"11b {name}: {mode} flows not finite or misshapen")
    # the tool's f32 model once more: its forward on the plain twins
    voxel, images = pr.random_inputs(cfg, size)
    model = pr.load_model(cfg, pr.load_state_dict(str(path)), "float32",
                          device="cuda")
    with plain_twins():
        twin = pr.model_flow(model, voxel, images, ITERS, RELEASED_TIMES)
    rel = pr.report(f"{name} f32 vs plain twins", out["flows"]["float32"],
                    twin)
    check(rel <= RELEASED_TOL,
          f"11b {name}: f32 kernel path vs plain twins {rel}")
    return {"family": name, "inferred": out["name"], "size": list(size),
            "iters": ITERS, "times": list(RELEASED_TIMES),
            "f32_rel_vs_plain_twins": rel, "tol": RELEASED_TOL,
            "bf16_vs_f32": out["rel"]["bf16_vs_f32"],
            "q8_vs_bf16": out["rel"]["q8_vs_bf16"],
            "max_abs_flow_f32": max(float(np.abs(f).max())
                                    for f in out["flows"]["float32"].values()),
            "launches": counts, "launches_per_forward": {
                k: v / len(modes) for k, v in counts.items()},
            "tf32_flags_after": list(flags_after), "seconds": seconds}


def stream_phase(workdir, seed: int) -> dict:
    """Phase 11: the streaming window (11a), the four released families
    through the tool (11b), and the lookup at their tables (11c). Returns
    what the kernels line reads."""
    from bflow_tpu_torch import parity_released as pr
    from bflow_tpu_torch import streaming as st
    from bflow_tpu_torch.models.corr import level_target_indices

    t_phase = time.perf_counter()
    stream = stream_window(seed)
    emit("stream_window", **stream)

    families = {}
    for idx, (name, kw) in enumerate(pr.RELEASED_FAMILIES):
        rec = released_family(workdir, idx, name, kw)
        emit("released_family", **rec)
        families[name] = rec

    # 11c. the all-level lookup at the events-only tables (one target at
    # levels 1-3) and the streaming table (32x40 queries), exact against
    # its twin; its int8 instantiation at the streaming table, where
    # pallas_q8 quantizes level 0 (32 rows) and not level 1 (16)
    fam = dict(pr.RELEASED_FAMILIES)
    tables = {}
    for what, cfg, size, dtype in (
            ("E_LU4_BD2", bt.RaftSplineConfig(**fam["E_LU4_BD2"]),
             RELEASED_SIZE[2], torch.float32),
            ("E_LU5_BD10", bt.RaftSplineConfig(**fam["E_LU5_BD10"]),
             RELEASED_SIZE[10], torch.float32),
            ("stream", st.STREAM_CONFIG, (st.H, st.W), torch.bfloat16)):
        targets = level_target_indices(cfg.levels_per_target)
        rec = check_lookup_pyramid(1, size[0] // 8, size[1] // 8, dtype,
                                   seed, targets=targets)
        rec["targets"] = [list(t) for t in targets]
        emit("kernel", name=klookup.NAME, table=what, **rec)
        check(rec["ok"], f"11c: all-level lookup at the {what} table "
                         f"disagrees: {rec}")
        tables[what] = rec
    targets = level_target_indices(st.STREAM_CONFIG.levels_per_target)
    q8_mixed, q8_only = check_q8_pyramid(1, st.H // 8, st.W // 8, seed,
                                         targets=targets)
    for what, rec in (("stream: int8 level 0, bf16 levels 1-3", q8_mixed),
                      ("stream: int8 level 0", q8_only)):
        emit("kernel", name=klookup.NAME, table=what, **rec)
        check(rec["ok"], f"11c: lookup over {what} disagrees: {rec}")
    check([lv[1] for lv in q8_mixed["levels"]]
          == ["int8", "bfloat16", "bfloat16", "bfloat16"],
          f"11c: streaming q8 table {q8_mixed['levels']}")
    emit("stream_phase", seconds=time.perf_counter() - t_phase)
    return {"stream": stream, "families": families, "tables": tables,
            "q8_mixed": q8_mixed, "q8_only": q8_only}


# ---------------------------------------------------------------------------
# phase 12: evaluation at the config's own precision (f32) through val and
# predict_dsec, the model's TF32 pin, the lookup at the path's f32 tables


F32_EVAL_TOL = 1e-4  # val/* relative, against the plain twins, TF32 off
MF_VAL_BATCH = 2  # MultiFlow's 3 val samples: a batch of 2 and a tail of 1


@contextlib.contextmanager
def tf32(on: bool):
    """Both TF32 flags (cuDNN convolutions, CUDA matmuls) set to `on`
    inside the block, the previous values restored after it."""
    prior = tf32_state()
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prior


def tf32_state():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def mf_val_args(root, ckpt, batch):
    """The CLI overrides of 12b: MultiFlow's val split, the experiment at
    full width (native 384x512), the config's own precision."""
    return ["dataset=multiflow_regen", "model=raft-spline",
            f"dataset.path={root}", f"checkpoint={ckpt}", MF_EXPERIMENT,
            f"batch_size={batch}", "hardware.num_workers=4"]


def f32_val(what: str, args, ckpt, cfg, workdir, n_fields: int, batch: int,
            h: int, w: int) -> dict:
    """12a / 12b: val.main with TF32 on in the caller (PyTorch's default):
    the composed config, the lookup launches derived per batch (one per
    iteration), the flags left as they were, and the CSV's val/* against
    make_eval_step over the same batches on the plain twins with TF32
    off."""
    sizes = batch_sizes(n_fields, batch)
    want = dict.fromkeys(kernels.KERNELS, 0)
    for n in sizes:
        for k, v in expected_launches(cfg, n, h, w, cfg.iters_test).items():
            want[k] += v
    out, counts, csv_row = val_run(args, workdir)
    check(tf32_state() == (True, True),
          f"12 {what}: val left the TF32 flags at {tf32_state()}")
    check(out["model_config"] == cfg,
          f"12 {what}: val built {out['model_config']}, not {cfg}")
    check(out["fields"] == n_fields, f"12 {what}: val saw {out['fields']}")
    check(counts == want, f"12 {what}: launches {counts}, derived {want} "
                          f"over batches {sizes}")
    metrics = {k: v for k, v in csv_row.items() if k.startswith("val/")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()),
          f"12 {what}: val metrics {metrics}")
    with tf32(False):
        plain = plain_twin_metrics(args, ckpt)
    rel = {k: abs(metrics[k] - plain[k]) / max(abs(plain[k]), 1e-6)
           for k in metrics}
    rec = {"config": what, "precision": [cfg.corr_precision,
                                         cfg.compute_dtype],
           "batch": batch, "batches": sizes, "height": h, "width": w,
           "fields": out["fields"], "seconds": out["seconds"],
           "loader_wait_share": out["loader_wait_share"],
           "launches": counts, "launches_per_forward": {
               k: v / len(sizes) for k, v in counts.items()},
           "launches_derived": want, "metrics": metrics,
           "plain_twin_metrics": plain, "rel_diff_vs_plain": rel,
           "bound": F32_EVAL_TOL, "tf32_flags_after": list(tf32_state())}
    emit("f32_val", **rec)
    check(all(v <= F32_EVAL_TOL for v in rel.values()),
          f"12 {what}: val metrics vs plain twins: {rel}")
    return rec


def pin_ab(ckpt, seed: int) -> dict:
    """12d: the flagship at f32 (test_mode, 480x640) and phase 6's train
    step, each run once with both TF32 flags on and once off, under
    deterministic cuDNN: the outputs, loss, gradients and updated weights
    bit-equal (the model and the step pin f32 themselves), the flags read
    back as set. A bare f32 conv with the flags on and off shows that TF32
    does change f32 arithmetic on this card (else the A/B could not tell)."""
    from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step
    from bflow_tpu_torch.train.checkpoint import restore_weights_only

    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(4, 64, 240, 320, generator=g, device="cuda")
    k = torch.randn(96, 64, 3, 3, generator=g, device="cuda") / 24
    bare = {}
    for on in (True, False):
        with tf32(on):
            bare[on] = F.conv2d(x, k, padding=1)
    bare_diff = rel_diff(bare[True], bare[False])
    cfg = dataclasses.replace(bt.flagship_config(), corr_precision="float32",
                              compute_dtype="float32")
    model = bt.RAFTSpline(cfg)
    restore_weights_only(ckpt, model)
    model = model.to("cuda").eval()
    voxel, images = flagship_inputs(seed)
    fwd, flags_read = {}, []
    for on in (True, False):
        with tf32(on):
            low, up = run_forward(model, voxel, images)
            flags_read.append(("forward", on, tf32_state()))
        fwd[on] = (low.params, up.params, up.flow_at(0.5))
    fwd_equal = all(torch.equal(a, b) for a, b in zip(fwd[True], fwd[False]))
    del model, fwd
    batch = train_batch(seed)
    steps = {}
    for on in (True, False):
        with tf32(on):
            model = damp_head(bt.build_model(train_config(), "cuda", seed))
            state = TrainState.create(model, TRAINING)
            step = make_train_step(model, TaskConfig("dsec"),
                                   state.optimizer, state.scheduler)
            metrics = step(batch)
            torch.cuda.synchronize()
            flags_read.append(("train step", on, tf32_state()))
        steps[on] = (metrics["train/l1_seq_loss"][0],
                     {n: p.grad for n, p in model.named_parameters()},
                     {n: p.detach() for n, p in model.named_parameters()})
    torch.backends.cudnn.deterministic = False
    (l1, g1, p1), (l0, g0, p0) = steps[True], steps[False]
    rec = {"bare_conv_rel_diff_tf32_on_vs_off": bare_diff,
           "forward_bit_equal": fwd_equal,
           "train_loss_bit_equal": bool(torch.equal(l1, l0)),
           "train_grads_bit_equal": all(torch.equal(g1[n], g0[n])
                                        for n in g0),
           "train_weights_bit_equal": all(torch.equal(p1[n], p0[n])
                                          for n in p0),
           "train_loss": l0.item(), "flags_set_and_read_after": flags_read,
           "forward": "flagship f32 test_mode, B=1 480x640, 12 iterations",
           "train_step": f"DSEC f32, B={TRAIN_B} at {TRAIN_H}x{TRAIN_W}"}
    emit("f32_pin", **rec)
    check(bare_diff > 0, "12d: a bare f32 conv is the same with TF32 on and "
                         "off: the A/B cannot tell")
    check(all(read == (on, on) for _, on, read in flags_read),
          f"12d: flags set and read after the calls: {flags_read}")
    check(fwd_equal and rec["train_loss_bit_equal"]
          and rec["train_grads_bit_equal"] and rec["train_weights_bit_equal"],
          f"12d: TF32 on vs off is not bit-equal: {rec}")
    return rec


def f32_eval_phase(workdir, seed: int) -> dict:
    """Phase 12: val on DSEC (12a) and on MultiFlow (12b) and predict_dsec
    (12c) at the config's own precision (f32), with TF32 on in the caller
    as PyTorch's default has it; the pin's A/B (12d); the lookup at the
    path's two new f32 tables (12e). Reuses phase 7's recordings and
    phase 9's samples where the workdir has them. Returns what the kernels
    line reads."""
    from bflow_tpu_torch.models.corr import level_target_indices

    t_phase = time.perf_counter()
    root, ckpt = dsec_setup(workdir, seed)
    mf_root, mf_ckpt, mf_cfg = multiflow_setup(workdir, seed)
    cfg = dataclasses.replace(bt.flagship_config(), corr_precision="float32",
                              compute_dtype="float32")
    check((mf_cfg.corr_precision, mf_cfg.compute_dtype)
          == ("float32", "float32"), f"12b: MultiFlow config {mf_cfg}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = True

    # 12a. val on DSEC at f32: the flagship experiment, no precision
    # override, B=4 over the 9 windows (4 + 4 + 1), reading 7c's caches
    dsec = f32_val("DSEC E_I_LU4_BD2 (flagship at the YAML's f32)",
                   val_args(root, ckpt, EVAL_BATCH, True, bf16=False), ckpt,
                   cfg, workdir, EVAL_WINDOWS, EVAL_BATCH, H, W)
    # 12b. val on MultiFlow at f32: E_I_LU5_BD10 at full width
    mf = f32_val("MultiFlow E_I_LU5_BD10", mf_val_args(
        mf_root, mf_ckpt, MF_VAL_BATCH), mf_ckpt, mf_cfg, workdir, MF_VAL,
        MF_VAL_BATCH, MF_H, MF_W)
    # 12c. predict_dsec at f32 against the plain twins, TF32 off
    pred = predict_run(workdir / "submission_f32", root, ckpt, cfg,
                       bf16=False, plain=True)
    pred["tf32_flags_after"] = list(tf32_state())
    emit("f32_predict", **pred)
    check(tf32_state() == (True, True),
          f"12c: predict_dsec left the TF32 flags at {tf32_state()}")

    # 12d. the pin's A/B
    ab = pin_ab(ckpt, seed)

    # 12e. the all-level lookup at the path's two new f32 tables: the
    # flagship's 11 target-level pairs at 12a's batch, and MultiFlow's 12
    # slots at 48x64 queries at 12b's batch
    tables = {}
    for what, n, (h1, w1), targets in (
            ("flagship f32 val", EVAL_BATCH, (H1, W1), PYRAMID_TARGETS),
            ("MultiFlow E_I f32 val", MF_VAL_BATCH, (MF_H // 8, MF_W // 8),
             level_target_indices(mf_cfg.levels_per_target))):
        rec = check_lookup_pyramid(n, h1, w1, torch.float32, seed,
                                   targets=targets)
        rec["targets"] = [list(t) for t in targets]
        emit("kernel", name=klookup.NAME, table=what, **rec)
        check(rec["ok"], f"12e: all-level lookup at the {what} table "
                         f"disagrees: {rec}")
        tables[what] = rec
    emit("f32_eval_phase", seconds=time.perf_counter() - t_phase)
    return {"dsec": dsec, "multiflow": mf, "predict": pred, "pin": ab,
            "tables": tables}


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conv-sweep", action="store_true",
                    help="after the build, time every tile variant of the "
                         "conv kernels on every flagship conv shape "
                         "(phase conv_sweep), and stop")
    ap.add_argument("--conv-loops", action="store_true",
                    help="after the build, check and time the conv3x3 "
                         "kernel's two main loops at every conv3x3 shape "
                         "at B=1 and B=16 (phase conv_loops), and stop")
    ap.add_argument("--lookup-probe", action="store_true",
                    help="after the build, time the lookup kernels' probe "
                         "variants (phase lookup_probe), and stop")
    ap.add_argument("--eval-only", action="store_true",
                    help="after the build, run only the evaluation path "
                         "(phases 7 and 12), and stop")
    ap.add_argument("--train-only", action="store_true",
                    help="after the build, run only MultiFlow training "
                         "through the training CLI (phase 9), and stop")
    ap.add_argument("--dist-only", action="store_true",
                    help="after the build, run only data-parallel training "
                         "(phase 10), and stop")
    ap.add_argument("--stream-only", action="store_true",
                    help="after the build, run only streaming inference and "
                         "the released-checkpoint tool (phase 11), and stop")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
         kernels={k: {"seconds": v["seconds"], "ptxas": v["ptxas"][-900:]}
                  for k, v in report.items()},
         conv_variants={k: conv_variant_resources(report[k]["ptxas"])
                        for k in (kstem.NAME, kconv.NAME)},
         lookup_fwd_variants=lookup_fwd_resources(
             report[klookup.NAME]["ptxas"]))

    if (args.conv_sweep or args.conv_loops or args.lookup_probe
            or args.eval_only
            or args.train_only or args.dist_only or args.stream_only):
        if args.conv_sweep:
            conv_sweep(args.seed)
        if args.conv_loops:
            conv_loops_phase(args.seed)
        if args.lookup_probe:
            lookup_probe(args.seed)
        if args.eval_only:
            with tempfile.TemporaryDirectory() as tmp:
                eval_phase(Path(tmp), args.seed)
                f32_eval_phase(Path(tmp), args.seed)
        if args.train_only:
            with tempfile.TemporaryDirectory() as tmp:
                train_phase(Path(tmp), args.seed)
        if args.dist_only:
            with tempfile.TemporaryDirectory() as tmp:
                dist_phase(Path(tmp), args.seed)
        if args.stream_only:
            with tempfile.TemporaryDirectory() as tmp:
                stream_phase(Path(tmp), args.seed)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. the all-level lookup forward (one launch per iteration) vs its
    # plain twin at the flagship shapes, exact; the one-level entry at
    # each level shape
    per_pyr = []
    for dtype in (torch.float32, torch.bfloat16):
        rec = check_lookup_pyramid(1, H1, W1, dtype, args.seed)
        emit("kernel", name=klookup.NAME, **rec)
        check(rec["ok"], f"all-level lookup kernel disagrees: {rec}")
        per_pyr.append(rec)
        for lvl, (Tl, hl, wl) in enumerate(LEVELS):
            rec = check_lookup_level(Tl, hl, wl, dtype, args.seed + lvl)
            emit("kernel_one_level", name=klookup.NAME, level=lvl, **rec)
            check(rec["ok"], f"one-level lookup disagrees: {rec}")
    # 3b. the backward: 12 iterations accumulated into one dVol buffer per
    # level, at the flagship shapes (bf16) and the DSEC training shapes
    # (f32, B=3 at 288x384); the one-level entry at each flagship level
    per_pyr_bwd = {}
    for name, (n, h1, w1), dtype in (
            ("flagship", (1, H1, W1), torch.bfloat16),
            ("train", (TRAIN_B, TRAIN_H // 8, TRAIN_W // 8), torch.float32)):
        rec = check_lookup_pyramid_bwd(n, h1, w1, dtype, args.seed)
        emit("kernel", name=klookup.BWD_NAME, shapes=name, **rec)
        check(rec["ok"], f"all-level lookup backward disagrees: {rec}")
        per_pyr_bwd[name] = rec
    for dtype in (torch.float32, torch.bfloat16):
        for lvl, (Tl, hl, wl) in enumerate(LEVELS):
            rec = check_lookup_bwd_level(Tl, hl, wl, dtype, args.seed + lvl)
            emit("kernel_one_level", name=klookup.BWD_NAME, level=lvl,
                 **rec)
            check(rec["ok"], f"one-level lookup backward disagrees: {rec}")

    # 3c. the opt-in kernels at every flagship shape they take: the lookup
    # over pallas_q8's tables (int8 levels 0-1 beside bf16 levels 2-3, and
    # the int8 levels alone), each int8 level through the one-level entry
    opt_cfg = opt_in_config()
    q8_mixed, q8_only = check_q8_pyramid(1, H1, W1, args.seed)
    for what, rec in (("int8 levels 0-1, bf16 levels 2-3", q8_mixed),
                      ("int8 levels 0-1", q8_only)):
        emit("kernel", name=klookup.NAME, table=what, **rec)
        check(rec["ok"], f"all-level lookup over {what} disagrees: {rec}")
    for lvl, (Tl, hl, wl) in enumerate(LEVELS):
        if quantizes(hl):
            rec = check_q8_level(Tl, hl, wl, args.seed + lvl)
            emit("kernel_one_level", name=klookup.NAME, level=lvl, **rec)
            check(rec["ok"], f"one-level int8 lookup disagrees: {rec}")
    per_conv = {kconv.NAME: [], kstem.NAME: []}
    for i, row in enumerate(flagship_convs(opt_cfg)):
        if row["kernel"] is None:
            continue
        rec = check_conv(row, args.seed + i)
        emit("kernel", name=row["kernel"], **rec)
        check(rec["ok"], f"{row['kernel']} disagrees: {rec}")
        per_conv[row["kernel"]].append(rec)
    conv_loops_phase(args.seed)
    # 3d. the norm kernel at the bf16 DSEC cell's encoder shapes
    norm_recs, norm_request_ms = norm_phase(args.seed)
    norm_f32_recs = norm_f32_phase(args.seed)
    # 3e. the convc1 kernel at the three map widths and the model's rows
    proj_recs, proj_request_ms = proj_phase(args.seed)

    # 4. the flagship forward through the kernel
    cfg = bt.flagship_config()
    model = bt.build_model(cfg, device="cuda", seed=args.seed)
    voxel, images = flagship_inputs(args.seed)
    n_fwd = 2
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(n_fwd):
        low, up = run_forward(model, voxel, images)
    counts = kernels.launch_counts()
    flow = up.flow_at(1.0)
    per_fwd = {k: v / n_fwd for k, v in counts.items()}
    emit("forward", config="flagship E_I_LU4_BD2 bf16 fuse_corr_conv",
         batch=1, height=H, width=W, iters=ITERS, forwards=n_fwd,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, launches_per_forward=per_fwd,
         flow_shape=list(flow.shape),
         finite=bool(torch.isfinite(up.params).all()))
    check(tuple(flow.shape) == (1, H, W, 2), f"flow shape {flow.shape}")
    check(bool(torch.isfinite(up.params).all())
          and bool(torch.isfinite(low.params).all()), "non-finite output")
    want = expected_launches(cfg)
    check(per_fwd == want,
          f"launches per forward {per_fwd}, derived {want} (one all-level "
          f"lookup launch per iteration)")
    del model

    # 4b. the opt-in flagship forward: q8 lookup, stem and conv kernels
    model = bt.build_model(opt_cfg, device="cuda", seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    low, up = run_forward(model, voxel, images)
    conv_common.reset_counters()
    low, up = run_forward(model, voxel, images)
    opt_counts = kernels.launch_counts()
    # the wrappers' own work in the second forward: one layout copy per
    # conv whose input has a channel count that is not a multiple of 8
    # (the stems, convf1), none elsewhere (the activations stay
    # channels-last between the kernels), and no weight prepared twice
    copies_per_fwd = conv_common.layout_copies
    preps_again = conv_common.weight_preps
    want_copies = sum(r["per_forward"] for r in flagship_convs(opt_cfg)
                      if r["kernel"] and r["shape"][1] % 8)
    opt_per_fwd = {k: v / n_fwd for k, v in opt_counts.items()}
    want_opt = expected_launches(opt_cfg)
    emit("opt_forward", config="flagship + pallas_q8 + pallas_stem + "
                              "pallas_conv, bf16",
         batch=1, height=H, width=W, iters=ITERS, forwards=n_fwd,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=opt_counts, launches_per_forward=opt_per_fwd,
         launches_per_forward_derived=want_opt,
         layout_copies_per_forward=copies_per_fwd,
         layout_copies_per_forward_derived=want_copies,
         weight_preps_in_second_forward=preps_again,
         finite=bool(torch.isfinite(up.params).all()))
    check(bool(torch.isfinite(up.params).all())
          and bool(torch.isfinite(low.params).all()), "opt-in: non-finite")
    check(opt_per_fwd == want_opt,
          f"opt-in launches per forward {opt_per_fwd}, derived {want_opt}")
    check(copies_per_fwd == want_copies and preps_again == 0,
          f"opt-in forward: {copies_per_fwd} layout copies per forward "
          f"(derived {want_copies}), {preps_again} weights prepared again")
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

    # 5b. the opt-in path: kernels vs their plain twins (the same
    # function), and, without a bound, vs the default flagship path
    kern = damp_head(bt.build_model(opt_cfg, "cuda", args.seed))
    _, up_k = run_forward(kern, voxel, images)
    with plain_twins():
        _, up_p = run_forward(kern, voxel, images)
    default = bt.build_model(cfg, "cuda", args.seed)
    default.load_state_dict(kern.state_dict())
    _, up_d = run_forward(default, voxel, images)
    rel = {str(t): rel_diff(up_k.flow_at(t), up_p.flow_at(t))
           for t in (0.5, 1.0)}
    rel_default = {str(t): rel_diff(up_k.flow_at(t), up_d.flow_at(t))
                   for t in (0.5, 1.0)}
    emit("opt_parity", precision="bfloat16", iters=ITERS, bound=5e-2,
         rel_diff=rel, rel_diff_vs_default_path=rel_default)
    check(all(v < 5e-2 for v in rel.values()),
          f"opt-in kernel path vs plain twins: {rel}")
    del kern, default, voxel, images

    # 6. the DSEC training step: f32, 12 iterations, B=3 at 288x384
    from bflow_tpu_torch.train import TaskConfig, TrainState, make_train_step

    tcfg = train_config()
    batch = train_batch(args.seed)
    # damped head: undamped, the random-init loss rises over the 7 steps
    model = damp_head(bt.build_model(tcfg, device="cuda", seed=args.seed))
    state = TrainState.create(model, TRAINING)
    task = TaskConfig("dsec")
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    stats0 = {k: v.clone() for k, v in model.cnet.state_dict().items()
              if "running" in k}
    n_steps = 7
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, finite = [], True
    for _ in range(n_steps):
        metrics = step(batch)
        losses.append(metrics["train/l1_seq_loss"][0].item())
        finite = finite and grads_finite(model)
    train_counts = kernels.launch_counts()
    per_step = {k: v / n_steps for k, v in train_counts.items()}
    moved = max((v - stats0[k]).abs().max().item()
                for k, v in model.cnet.state_dict().items() if k in stats0)
    emit("train", config="flagship E_I_LU4_BD2 f32 fuse_corr_conv, "
                         "damped head",
         batch=TRAIN_B, height=TRAIN_H, width=TRAIN_W, iters=tcfg.iters_train,
         steps=n_steps, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=train_counts, launches_per_step=per_step, losses=losses,
         lr=state.optimizer.param_groups[0]["lr"], grads_finite=finite,
         cnet_running_stats_moved=moved)
    want = tcfg.iters_train  # one all-level launch per iteration each way
    for name in (klookup.NAME, klookup.BWD_NAME):
        check(per_step[name] == want,
              f"{name}: {per_step[name]} launches per step, want {want}")
    check(all(np.isfinite(losses)) and finite, f"non-finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(moved > 0, "cnet BatchNorm statistics did not move")
    # dVol per step: one zeroing per level (the accumulators), no sum of
    # per-iteration dVols
    levels = build_corr_pyramid_shapes(tcfg)
    dvol = dvol_ops(lambda: step(batch), levels)
    emit("train_step_dvol", config="dsec", **dvol, levels=len(levels))
    check(dvol["dvol_zero"] == len(levels) and dvol["dvol_sum"] == 0,
          f"train step dVol: {dvol['dvol_zero']} zeroings, "
          f"{dvol['dvol_sum']} sums; want {len(levels)} and 0")
    del model, state, step

    # 6b. one bf16 flagship step
    model = damp_head(bt.build_model(bt.flagship_config(), device="cuda",
                                     seed=args.seed))
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    kernels.reset_launch_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    bf16_counts = kernels.launch_counts()
    bf16_loss = metrics["train/l1_seq_loss"][0].item()
    emit("train_bf16", loss=bf16_loss, launches=bf16_counts,
         grads_finite=grads_finite(model))
    check(np.isfinite(bf16_loss) and grads_finite(model), "bf16 step")
    check(all(bf16_counts[n] == want for n in (klookup.NAME,
                                               klookup.BWD_NAME)),
          f"bf16 step launches {bf16_counts}")
    del model, state, step

    # 6c. one bf16 flagship step with the stem and conv kernels (lookup
    # 'pallas': the int8 lookup has no gradient), then its gradients
    # against the same step through the plain twins: within 5e-2 of each
    # weight's max, or within the default path's own distance from the
    # twins where bf16 noise is larger than that (the stems' weights,
    # whose gradients cancel through instance norm)
    conv_cfg = dataclasses.replace(opt_cfg, lookup_method="pallas")
    model = damp_head(bt.build_model(conv_cfg, device="cuda",
                                     seed=args.seed))
    state = TrainState.create(model, TRAINING)
    step = make_train_step(model, task, state.optimizer, state.scheduler)
    kernels.reset_launch_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    conv_counts = kernels.launch_counts()
    conv_loss = metrics["train/l1_seq_loss"][0].item()
    want_conv = expected_launches(conv_cfg, TRAIN_B, TRAIN_H, TRAIN_W,
                                  conv_cfg.iters_train, train=True)
    want_conv[klookup.BWD_NAME] = want_conv[klookup.NAME]
    finite = grads_finite(model)
    del model, state, step
    torch.backends.cudnn.deterministic = True
    lk, gk = step_grads(conv_cfg, batch, args.seed, True)
    lp, gp = step_grads(conv_cfg, batch, args.seed, True, plain=True)
    # the bf16 noise floor of the step: the default path (cuDNN convs,
    # bf16 bias) against the same plain twins
    _, gd = step_grads(dataclasses.replace(conv_cfg, pallas_stem=False,
                                           pallas_conv=False),
                       batch, args.seed, True)
    torch.backends.cudnn.deterministic = False
    worst, where = grad_rel(gk, gp)
    floor, floor_where = grad_rel(gd, gp)
    bound = max(5e-2, floor)
    emit("train_conv", loss=conv_loss, launches=conv_counts,
         launches_derived=want_conv, grads_finite=finite,
         loss_rel_vs_plain=abs(lk - lp) / abs(lp), grad_rel_max=worst,
         worst_param=where, default_path_grad_rel_max=floor,
         default_path_worst_param=floor_where, bound=bound)
    check(np.isfinite(conv_loss) and finite, "bf16 conv-kernel step")
    check(conv_counts == want_conv,
          f"conv-kernel step launches {conv_counts}, derived {want_conv}")
    check(worst <= bound, f"conv-kernel step gradients vs plain: {worst}")

    # 6d. train parity: kernel path vs gather path, one step's gradients
    for precision, iters, damp, bound in (("float32", 2, False, 1e-4),
                                          ("bfloat16", ITERS, True, 5e-2)):
        c = dataclasses.replace(tcfg, corr_precision=precision,
                                compute_dtype=precision, iters_train=iters)
        loss_rel, (grad_worst, where), (floor, _) = train_parity(
            c, batch, args.seed, damp)
        loss_bound = 1e-5 if precision == "float32" else bound
        emit("train_parity", precision=precision, iters=iters,
             loss_rel=loss_rel, grad_rel_max=grad_worst, worst_param=where,
             gather_repeat_grad_rel_max=floor,
             bounds={"loss": loss_bound, "grad": bound})
        check(loss_rel <= loss_bound and grad_worst <= bound,
              f"train parity {precision}: {loss_rel} {grad_worst}")

    with tempfile.TemporaryDirectory() as tmp:
        # 7. the DSEC evaluation path: recordings written to disk, the
        # device voxelizer, val and predict_dsec through their entry points
        eval_counts, eval_opt_counts = eval_phase(Path(tmp), args.seed)

        # 9. MultiFlow training through the training CLI: fabricated
        # samples, two epochs with validation, checkpoints and media, the
        # resume, step 1 on the plain twins, the lookups at these shapes;
        # 10. data-parallel training, the CLI's runs on phase 9's samples
        mf_counts, mf_fwd, mf_bwd = train_phase(Path(tmp), args.seed)
        dist_counts = dist_phase(Path(tmp), args.seed)

        # 11. streaming inference over raw events at full width, the four
        # released families through the parity tool at their native sizes,
        # the lookup at their tables
        p11 = stream_phase(Path(tmp), args.seed)

        # 12. val (DSEC and MultiFlow) and predict_dsec at the config's own
        # f32 on phase 7's recordings and phase 9's samples, TF32 on in the
        # caller; the pin's A/B; the lookup at the path's f32 tables
        p12 = f32_eval_phase(Path(tmp), args.seed)

    # 8. kernels line: the lookups per iteration at the flagship shapes
    # (bf16; the backward also at the training shapes, f32), one launch
    # for every level; the convs per forward, the sum over their shapes of
    # time x launches per forward
    fwd = next(r for r in per_pyr if r["dtype"] == "bfloat16")
    bwd = per_pyr_bwd["flagship"]

    def bwd_fields(r):
        return {k: r[k] for k in ("ms", "zero_ms_per_step", "plain_ms",
                                  "bound_ms", "library_ms")}

    def launches_dp(counts, name):
        return {"world1_nccl_first_step": counts["world1_nccl"][name],
                "two_ranks_gloo_first_step": [
                    c[name] for c in counts["two_ranks_gloo"]]}

    def table_fields(r):
        return {**{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "library_ms", "queries",
                                     "dtype")},
                "x_bound": r["ms"] / r["bound_ms"]}

    def multiflow(r, err_keys):
        return {"max_abs_err": max(r[k] for k in err_keys),
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms", "queries", "dtype")},
                "x_bound": r["ms"] / r["bound_ms"],
                "per": "iteration, 12 slots over four levels, MultiFlow "
                       "training shapes (f32, B=3 at 368x496)"}

    summary = [{
        "name": klookup.NAME,
        "route": "cuda",
        "source": "bflow_tpu_torch/csrc/corr_lookup_fwd.cu",
        "replaces": "bflow_tpu/ops/pallas/corr_lookup_v3.py:238",
        "launches": counts[klookup.NAME],
        "launches_train": train_counts[klookup.NAME],
        "launches_eval": eval_counts[klookup.NAME],
        "launches_train_multiflow": mf_counts[klookup.NAME],
        "launches_data_parallel": launches_dp(dist_counts, klookup.NAME),
        "launches_stream": p11["stream"]["launches"][klookup.NAME],
        "launches_released": {
            k: r["launches"][klookup.NAME]
            for k, r in p11["families"].items()},
        "launches_eval_f32": {
            "dsec_val": p12["dsec"]["launches"][klookup.NAME],
            "multiflow_val": p12["multiflow"]["launches"][klookup.NAME],
            "predict_dsec": p12["predict"]["launches"][klookup.NAME]},
        "max_abs_err": max(r["max_abs_err"] for r in [
            *per_pyr, mf_fwd, *p11["tables"].values(),
            *p12["tables"].values()]),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": fwd["library_ms"],
        "per": "iteration, all four levels, flagship bf16",
        "multiflow": multiflow(mf_fwd, ["max_abs_err"]),
        "events_only_and_stream": {
            k: {**table_fields(r), "per": "iteration, all four levels"}
            for k, r in p11["tables"].items()},
        "f32_eval": {
            k: {**table_fields(r), "per": "iteration, all four levels"}
            for k, r in p12["tables"].items()},
    }, {
        "name": klookup.BWD_NAME,
        "route": "cuda",
        "source": "bflow_tpu_torch/csrc/corr_lookup_bwd.cu",
        "replaces": "bflow_tpu/ops/pallas/corr_lookup_v3.py:542",
        "launches": train_counts[klookup.BWD_NAME],
        "launches_eval": eval_counts[klookup.BWD_NAME],
        "launches_train_multiflow": mf_counts[klookup.BWD_NAME],
        "launches_data_parallel": launches_dp(dist_counts,
                                              klookup.BWD_NAME),
        "max_abs_err": max(max(r["dvol_max_abs_err"],
                               r["dcoords_max_abs_err"])
                           for r in [*per_pyr_bwd.values(), mf_bwd]),
        **bwd_fields(bwd),
        "bound_by": "bytes",
        "per": "iteration, all four levels, flagship bf16",
        "train_f32": bwd_fields(per_pyr_bwd["train"]),
        "multiflow": multiflow(mf_bwd, ["dvol_max_abs_err",
                                        "dcoords_max_abs_err"]),
    }, {
        "name": f"{klookup.NAME} (int8 levels)",
        "route": "cuda",
        "source": "bflow_tpu_torch/csrc/corr_lookup_fwd.cu",
        "replaces": "bflow_tpu/ops/pallas/corr_lookup_v3.py:238",
        "variant": "quant=True (lookup_level_slab_q8, :794): pallas_q8's "
                   "int8 levels in the all-level kernel's table",
        "launches": opt_counts[klookup.NAME],
        "launches_eval": eval_opt_counts[klookup.NAME],
        "launches_released": "12 per pallas_q8 forward, counted with "
                             "the f32 and bf16 forwards' under "
                             f"{klookup.NAME}",
        "max_abs_err": max(r["max_abs_err"] for r in (
            q8_mixed, q8_only, p11["q8_mixed"], p11["q8_only"])),
        "ms": q8_only["ms"],
        "plain_ms": q8_only["plain_ms"],
        "bound_ms": q8_only["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": q8_only["library_note"],
        "per": "iteration, the int8 levels 0-1 as one table launch, flagship",
        "opt_in_table": {k: q8_mixed[k] for k in (
            "ms", "plain_ms", "bound_ms", "x_bound", "bf16_levels_alone_ms")},
        "stream": {
            "int8_level_0": {k: p11["q8_only"][k] for k in (
                "ms", "plain_ms", "bound_ms", "x_bound", "max_abs_err")},
            "q8_table": {k: p11["q8_mixed"][k] for k in (
                "ms", "plain_ms", "bound_ms", "x_bound", "max_abs_err")}},
    }, conv_summary(kstem.NAME, "bflow_tpu/ops/pallas/stem_conv.py:114",
                    per_conv[kstem.NAME], opt_counts, eval_opt_counts),
        conv_summary(kconv.NAME, "bflow_tpu/ops/pallas/conv3x3.py:69",
                     per_conv[kconv.NAME], opt_counts, eval_opt_counts),
        norm_summary(norm_recs, norm_request_ms, counts, eval_counts,
                     norm_f32_recs),
        proj_summary(proj_recs, proj_request_ms, counts, eval_counts)]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
