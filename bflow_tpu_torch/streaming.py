"""Streaming inference from raw events, on the device (counterpart of
examples/streaming_inference.py).

Raw padded event tensors go to the device once, are rasterized there into
the merged voxel grid (ops/voxelize.py), and an events-only RAFT-Spline
gives Bezier flow curves, read out at continuous query times: no host-side
voxel building, no voxel cache, no host round trip inside a window.

    python -m bflow_tpu_torch.streaming [--device cpu] [--events N]
        [--windows K]

    from bflow_tpu_torch import streaming
    model, pipeline = streaming.make_pipeline(device="cuda")
    flows = pipeline(x, y, p, t, valid, t0, t1, (0.25, 0.5, 0.75, 1.0))

`main` runs synthetic events (300,000 per window, padded to 2^19): the
first window on its own (kernel build included), then K windows on the
host clock ending in one readback of the flows' sum, and the split of
those windows into the voxelizer and the forward (CUDA events on the
GPU, the host clock on the CPU). Timestamps are window-relative
(0-200,000 us), which f32 holds exactly: the voxelizer casts them to f32
before it subtracts the window start.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from bflow_tpu_torch.models import RAFTSpline, RaftSplineConfig
from bflow_tpu_torch.ops.voxelize import voxelize_events

# A small streaming config: 5 context bins over a 100 ms window.
STREAM_CONFIG = RaftSplineConfig(
    nbins_context=5,
    nbins_correlation=5,
    ev_target_indices=(1, 2, 3, 4),
    ev_levels=(1, 1, 1, 4),
    use_images=False,
    iters_test=6,
    corr_precision="bfloat16",
    compute_dtype="bfloat16",
)
H, W = 256, 320
EVENT_CAPACITY = 1 << 19  # static padding (524k events/window)
N_EVENTS = 300_000
# the window [t0, t1] in us; the grid spans [t0 - (t1 - t0), t1]
T0, T1 = 100_000, 200_000
QUERY_TIMES = (0.25, 0.5, 0.75, 1.0)


def window_grid(x, y, p, t, valid, t0, t1, *, channels: int, height: int,
                width: int) -> torch.Tensor:
    """Raw padded events -> the merged (H, W, channels) voxel grid, which
    spans 2 * nbins - 1 bins over [t0 - (t1 - t0), t1]."""
    window = t1 - t0
    return voxelize_events(x, y, p, t, valid, t0 - window, t1,
                           channels=channels, height=height, width=width)


def grid_flows(model: RAFTSpline, grid: torch.Tensor,
               query_times: Sequence[float]) -> torch.Tensor:
    """Voxel grid -> flows (T, 1, H, W, 2) at the query times."""
    _, up = model(grid[None], None, test_mode=True)
    return up.flow_at(query_times)


def make_pipeline(cfg: RaftSplineConfig = STREAM_CONFIG, height: int = H,
                  width: int = W, device="cuda", seed: int = 0):
    """(model, pipeline): the model with seeded random weights on
    ``device``, and the window function
    pipeline(x, y, p, t, valid, t0, t1, query_times) -> (T, 1, H, W, 2)."""
    from bflow_tpu_torch import build_model

    model = build_model(cfg, device=device, seed=seed)

    def pipeline(x, y, p, t, valid, t0, t1, query_times):
        """Raw padded events -> merged voxel grid -> continuous flow."""
        grid = window_grid(x, y, p, t, valid, t0, t1,
                           channels=cfg.nbins_total, height=height,
                           width=width)
        return grid_flows(model, grid, query_times)

    return model, pipeline


def synthetic_events(rng: np.random.Generator, n: int, height: int = H,
                     width: int = W):
    """n random events (x, y, polarity, t), t sorted in [0, 200,000) us:
    the example's draws, in its order."""
    return (
        rng.integers(0, width, n).astype(np.int32),
        rng.integers(0, height, n).astype(np.int32),
        rng.integers(0, 2, n).astype(np.float32),
        np.sort(rng.integers(0, 200_000, n)).astype(np.int32),
    )


def window_inputs(events, capacity: int, device) -> tuple:
    """Events padded to ``capacity`` on ``device``, with the valid mask
    and the window bounds as device scalars: (x, y, p, t, valid, t0, t1)."""
    n = events[0].shape[0]
    if n > capacity:
        raise ValueError(f"{n} events exceed the capacity {capacity}")
    pad = capacity - n
    valid = np.zeros(capacity, bool)
    valid[:n] = True
    arrays = [np.pad(a, (0, pad)) for a in events] + [valid]
    return tuple(torch.from_numpy(a).to(device) for a in arrays) + (
        torch.tensor(T0, device=device), torch.tensor(T1, device=device))


class _Split:
    """Time the voxelizer and the forward of each window: CUDA events on
    the GPU (read after the last window), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            evt = torch.cuda.Event(enable_timing=True)
            evt.record()
            self.marks.append(evt)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def main(argv=None, device="cuda") -> Dict[str, Any]:
    """Runs the synthetic stream; prints the first window's time, ms per
    window, windows/s and the split, and returns them."""
    from bflow_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=device)
    ap.add_argument("--events", type=int, default=N_EVENTS)
    ap.add_argument("--windows", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    height, width = H, W

    rng = np.random.default_rng(0)
    model, pipeline = make_pipeline(height=height, width=width, device=dev)
    n = args.events
    inputs = window_inputs(synthetic_events(rng, n, height, width),
                           EVENT_CAPACITY, dev)
    query_times = QUERY_TIMES

    t0 = time.perf_counter()
    flows = pipeline(*inputs, query_times)
    s = float(flows.sum())
    first_s = time.perf_counter() - t0
    print(f"build+first window: {first_s:.0f}s")

    K = args.windows
    split = _Split(dev)
    t0 = time.perf_counter()
    for k in range(K):
        split.mark()
        grid = window_grid(*inputs, channels=model.config.nbins_total,
                           height=height, width=width)
        split.mark()
        out = grid_flows(model, grid, query_times)
        split.mark()
        if k == K - 1:
            s = float(out.sum())
    dt = (time.perf_counter() - t0) / K
    voxel_ms = sum(split.ms(3 * k, 3 * k + 1) for k in range(K)) / K
    forward_ms = sum(split.ms(3 * k + 1, 3 * k + 2) for k in range(K)) / K
    finite = bool(torch.isfinite(out).all())
    print(
        f"streaming window ({n} raw events -> voxel grid -> "
        f"{len(query_times)} continuous-time flow fields @ {height}x{width}): "
        f"{dt * 1000:.1f} ms -> {1 / dt:.1f} windows/s")
    clock = "CUDA events" if split.cuda else "host clock"
    print(f"split ({clock}, mean of {K} windows): voxelizer "
          f"{voxel_ms:.3f} ms, forward {forward_ms:.3f} ms")
    print("flow shapes:", tuple(out.shape), "finite:", finite)
    return {"events": n, "capacity": EVENT_CAPACITY,
            "size": [height, width], "windows": K,
            "first_window_s": first_s, "ms_per_window": dt * 1e3,
            "windows_per_s": 1 / dt, "voxelizer_ms": voxel_ms,
            "forward_ms": forward_ms, "flow_shape": list(out.shape),
            "finite": finite, "flow_sum": s}


if __name__ == "__main__":
    main()
