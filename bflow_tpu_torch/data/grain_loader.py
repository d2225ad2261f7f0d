"""Worker-process, process-sharded input pipeline (`hardware.loader=grain`).

Counterpart of bflow_tpu/data/grain_loader.py, which builds on Grain:
worker *processes* (the Python-heavy parts of augmentation run outside
the training process's GIL), a per-record RNG, and sharding by process.
The card's machine has no grain, so the port builds the same on
torch.utils.data.DataLoader workers, behind the threaded Loader's
interface (``__len__``, ``peek``, ``set_epoch``, ``iterate(start, end)``,
``wait_s``, the hand-off to the device through pinned memory).

Order and randomness are the threaded Loader's, not Grain's: the epoch's
order is the (seed, epoch) permutation, a process takes
``order[rank::world]`` cut to floor(n / world) items (a disjoint cover of
the epoch; ``__len__`` per shard is floor(n / world) // batch, as Grain's
``ShardByJaxProcess(drop_remainder=True)`` gives), and item i draws from
``SeedSequence((seed, epoch, i))``. A batch is therefore bit-equal
whichever of the port's loaders made it. (Grain shuffles with its own
algorithm, seeded with seed + epoch, and derives each record's RNG its own
way: the JAX package's two loaders give different batches.)

Workers start with the 'spawn' method and stay up across epochs. A forked
worker would inherit the training process's locks in whatever state its
other threads held them (data/io.py's h5py_lock, the blosc codec's lock),
its open HDF5 handles and its CUDA context, none of which is safe in the
child; a spawned worker starts clean and receives the dataset pickled
(the datasets open their files lazily, in each process). The price is a
start of a few seconds per worker, paid once per loader.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from bflow_tpu_torch.data.loader import (Loader, _collate, _map, fetch,
                                         to_device)


class _Items(torch.utils.data.Dataset):
    """Dataset items keyed by (epoch, index), each with its own RNG."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __getitem__(self, key):
        epoch, index = key
        return fetch(self.dataset, self.seed, epoch, index)


def _collate_tensors(items: list) -> Dict[str, Any]:
    """The Loader's collation, as tensors (the DataLoader pins those)."""
    return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                _collate(items))


class ProcessLoader(Loader):
    """The threaded Loader's batches, loaded by ``num_workers`` worker
    processes (each one whole batch at a time; ``prefetch_batches`` in
    flight per worker)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the batch sampler: the (epoch, index) keys of the batches of the
        # next pass, refilled in place before each
        self._sampler: list = []
        self._loader: Optional[torch.utils.data.DataLoader] = None

    def _data_loader(self) -> torch.utils.data.DataLoader:
        if self._loader is None:
            pin = self.device is not None and self.device.type == "cuda"
            self._loader = torch.utils.data.DataLoader(
                _Items(self.dataset, self.seed),
                batch_sampler=self._sampler,
                num_workers=self.num_workers,
                collate_fn=_collate_tensors,
                pin_memory=pin,
                prefetch_factor=self.prefetch,
                persistent_workers=True,
                multiprocessing_context="spawn",
            )
        return self._loader

    def iterate(self, start: int = 0, end: Optional[int] = None
                ) -> Iterator[Dict[str, Any]]:
        """The epoch's batches ``start`` to ``end``, as the threaded
        Loader's ``iterate``."""
        self.wait_s = 0.0
        self._sampler[:] = [[(self.epoch, int(i)) for i in b]
                            for b in self._batches(start, end)]
        if not self._sampler:
            return
        batches = iter(self._data_loader())
        device = self.device
        for _ in range(len(self._sampler)):
            t0 = time.perf_counter()
            batch = next(batches)
            self.wait_s += time.perf_counter() - t0
            if device is None:
                yield _map(lambda t: t.numpy(), batch)
            else:
                yield to_device(batch, device)
