"""Process-group initialisation, rank helpers, the differentiable sum over
ranks, and the launcher that spawns ranks itself.

Counterpart of bflow_tpu/parallel/distributed.py. The JAX package runs
data-parallel as one program over a global mesh, and XLA inserts every
collective; here each rank is a process, and the port's own code issues
the collectives the global batch needs: DDP's gradient all-reduce, one
all-reduce of BatchNorm's sums per norm (models/extractor.py), one of the
loss's valid count and one of the step's packed metric sums
(train/step.py).

A process group is initialised from a launcher's environment (torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or from explicit arguments; for one process without a launcher
``initialize_distributed`` returns False and does nothing, as the JAX one
does. The backend is NCCL for CUDA and gloo for the CPU unless the caller
names one: gloo also all-reduces CUDA tensors, so it can put several ranks
on one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_KEYS = ("RANK", "WORLD_SIZE")
# how long a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 600.0


def launched() -> bool:
    """True under a launcher (torchrun) that set this process's rank."""
    return all(k in os.environ for k in _LAUNCHER_KEYS)


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: the CPU stays the CPU, None or 'cuda' is the card
    of the rank's local index, an explicit 'cuda:k' puts every rank on
    card k."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cpu",
                           timeout_s: float = COLLECTIVE_TIMEOUT_S) -> bool:
    """Initialise the default process group; returns whether one is up.

    Without a launcher's environment and without ``init_method`` or
    ``world_size`` this is a no-op that returns False (one process). A
    group that is already up is kept. ``device`` picks the default
    backend and, for CUDA, becomes the current device (NCCL binds each
    rank to it). ``timeout_s`` bounds each collective's wait for the
    other ranks."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and not launched():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def is_primary_host() -> bool:
    """Rank-zero guard for logging and checkpoints."""
    return process_index() == 0


def host_local_batch_slice(global_batch_size: int) -> slice:
    """The index range of the global batch this process loads."""
    n_proc = process_count()
    assert global_batch_size % n_proc == 0, (global_batch_size, n_proc)
    per = global_batch_size // n_proc
    idx = process_index()
    return slice(idx * per, (idx + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks. Every rank's output is the same sum, so the
    cotangent of one rank's input is the sum over ranks of the cotangents
    of their outputs: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over ranks (a copy of ``x`` without a
    process group)."""
    if not is_initialized():
        return x.clone()
    return _AllReduceSum.apply(x)


# ---------------------------------------------------------------------------
# spawning ranks without a launcher


def _entry(rank: int, fn: Callable, world: int, workdir: str, device,
           backend: Optional[str], threads: int,
           args: Sequence[Any]) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(threads)
    initialize_distributed(
        init_method=f"file://{Path(workdir) / 'rendezvous'}",
        world_size=world, rank=rank, backend=backend, device=dev)
    try:
        out = fn(*args, device=dev, backend=backend)
        if rank == 0:
            with open(Path(workdir) / "result.pkl", "wb") as fh:
                pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), device="cpu",
          backend: Optional[str] = None,
          timeout_s: Optional[float] = None,
          workdir: Optional[str] = None) -> Any:
    """Run ``fn(*args, device=<rank's device>, backend=backend)`` in
    ``world`` new processes (the 'spawn' start method: nothing of this
    process's state, a CUDA context or a held lock, is inherited), each
    rank of one process group met through a file in a fresh temporary
    directory (inside ``workdir`` where given). Returns rank 0's result.
    If one rank fails the others are ended and the failure is raised.
    ``timeout_s`` is a deadline for the whole run: past it every rank is
    killed and TimeoutError raised; None (a training run) waits until the
    ranks end. It is apart from the process group's own bound on each
    collective (COLLECTIVE_TIMEOUT_S). ``fn`` must be importable by name.
    CPU ranks share this process's intra-op threads."""
    import torch.multiprocessing as tmp

    threads = max(1, torch.get_num_threads() // world)
    workdir = tempfile.mkdtemp(prefix="bflow_ranks_", dir=workdir)
    try:
        ctx = tmp.start_processes(
            _entry, args=(fn, world, workdir, device, backend, threads,
                          tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else (time.monotonic()
                                                    + timeout_s)
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{world} ranks ran past {timeout_s} s")
        with open(Path(workdir) / "result.pkl", "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
