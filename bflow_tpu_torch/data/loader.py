"""Batched, threaded, prefetching data loader (copy of
bflow_tpu/data/loader.py, with the hand-off to the device).

The hot per-item work — HDF5 reads, gzip/zstd decompression, NumPy
scatter-adds, PNG decoding — releases the GIL, so a thread pool gets
process-level parallelism without pickling or IPC. Batches are collated
NumPy arrays in the JAX package's layouts; with ``device`` set they go to
that device as tensors: the producer thread copies each array into pinned
host memory (for a CUDA device), and the consumer issues one
``non_blocking`` copy per array on the current stream, so the transfer
overlaps the device's work on the previous batch.

Determinism: per-epoch, per-item RNGs are derived from (seed, epoch,
index) with `np.random.SeedSequence`, so augmentation is reproducible
regardless of worker scheduling and independent of the number of
workers; `peek()` draws the head batch's items from one
`default_rng(seed)`, as the JAX loader does.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from bflow_tpu_torch.data.keys import DataLoading as K

# Keys whose per-item leading axis must stay leading in the batch:
# IMG (2, H, W, 3) -> (2, N, H, W, 3); MultiFlow FLOW (M, H, W, 2)
# -> (M, N, H, W, 2). Everything else batches at axis 0.
_AXIS1_KEYS = {K.IMG.value}


def _collate(items: list) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    first = items[0]
    for key, val in first.items():
        vals = [it[key] for it in items]
        if isinstance(val, dict):
            out[key] = _collate(vals)
        elif isinstance(val, np.ndarray):
            stacked = np.stack(vals)
            if key in _AXIS1_KEYS or (key == K.FLOW.value and val.ndim == 4):
                stacked = np.moveaxis(stacked, 0, 1)
            out[key] = stacked
        else:
            out[key] = np.asarray(vals)
    return out


def make_loader(dataset, kind: str = "threaded", **kw):
    """Config-selectable input pipeline (`hardware.loader`): 'threaded'
    is the thread-pool Loader below, 'grain' the worker-process loader
    of data/grain_loader.py (the value keeps the JAX package's name).
    Both take the same arguments and yield the same batches."""
    if kind in (None, "threaded"):
        return Loader(dataset, **kw)
    if kind == "grain":
        from bflow_tpu_torch.data.grain_loader import ProcessLoader

        return ProcessLoader(dataset, **kw)
    raise ValueError(f"unknown loader kind: {kind!r}")


def fetch(dataset, seed: int, epoch: int, index: int) -> Dict[str, Any]:
    """Item ``index`` of the epoch, drawing from its own RNG."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, epoch, index)))
    get_item = getattr(dataset, "get_item", None)
    if get_item is not None:
        return get_item(int(index), rng)
    return dataset[int(index)]


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def pin(batch, device: torch.device):
    """Host arrays -> tensors, in pinned memory when bound for CUDA."""
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if device.type == "cuda" else t

    return _map(one, batch)


def to_device(batch, device: torch.device):
    """Tensors (from ``pin``) -> ``device``, each one non_blocking copy."""
    return _map(lambda t: t.to(device, non_blocking=True), batch)


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        prefetch_batches: int = 2,
        shard: "tuple[int, int] | None" = None,
        device: "torch.device | str | None" = None,
    ):
        assert batch_size >= 1
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch_batches)
        self.epoch = 0
        # (rank, world): every process builds the SAME (seed, epoch)-keyed
        # global order and takes the strided slice order[rank::world]
        # (truncated to equal length): a disjoint cover of the epoch.
        self.shard = shard
        if shard is not None:
            rank, world = shard
            assert 0 <= rank < world, shard
        # None: NumPy batches, as the JAX loader yields
        self.device = None if device is None else torch.device(device)
        # seconds the consumer spent waiting for a batch, this iteration
        self.wait_s = 0.0

    def _epoch_len(self) -> int:
        n = len(self.dataset)
        if self.shard is not None:
            n = n // self.shard[1]
        return n

    def __len__(self) -> int:
        n = self._epoch_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def peek(self) -> Dict[str, Any]:
        """One deterministic host batch (dataset head) WITHOUT starting
        the producer pipeline. Used to derive shapes."""
        rng = np.random.default_rng(self.seed)
        items = [
            self._fetch_with(i, rng)
            for i in range(min(self.batch_size, len(self.dataset)))
        ]
        return _collate(items)

    def _fetch_with(self, index: int, rng):
        get_item = getattr(self.dataset, "get_item", None)
        if get_item is not None:
            return get_item(int(index), rng)
        return self.dataset[int(index)]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _fetch(self, index: int) -> Dict[str, Any]:
        return fetch(self.dataset, self.seed, self.epoch, index)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.iterate()

    def _batches(self, start: int, end: Optional[int]) -> list:
        """The dataset indices of the epoch's batches ``start`` to
        ``end``."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence((self.seed, self.epoch))
            ).permutation(n)
        if self.shard is not None:
            rank, world = self.shard
            order = order[rank :: world][: self._epoch_len()]
        nb = len(self)
        return [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(start, nb if end is None else min(end, nb))
        ]

    def iterate(self, start: int = 0, end: Optional[int] = None
                ) -> Iterator[Dict[str, Any]]:
        """The epoch's batches ``start`` to ``end`` (a resumed run skips
        the ones it has trained on, and a limited epoch the ones it will
        not train on, without loading them)."""
        batches = self._batches(start, end)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        device = self.device

        def put(item) -> bool:
            # a consumer that stops early (a break) never drains the
            # queue: give up once it has gone, rather than block forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    try:
                        batch = _collate(list(pool.map(self._fetch, idxs)))
                        if device is not None:
                            batch = pin(batch, device)
                    except Exception as e:  # surface in consumer
                        put(e)
                        return
                    if not put(batch):
                        return
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        self.wait_s = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                item = out_q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item if device is None else to_device(item, device)
        finally:
            stop.set()
