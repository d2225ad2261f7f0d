"""Dataset provider interface + simple dataset composition utilities
(copy of bflow_tpu/data/provider.py)."""

from __future__ import annotations

import abc
import bisect
from typing import List, Sequence


class DatasetProviderBase(abc.ABC):
    """Train/val/test datasets + temporal-bin metadata."""

    @abc.abstractmethod
    def get_train_dataset(self):
        ...

    @abc.abstractmethod
    def get_val_dataset(self):
        ...

    @abc.abstractmethod
    def get_test_dataset(self):
        ...

    @abc.abstractmethod
    def get_nbins_context(self) -> int:
        ...

    @abc.abstractmethod
    def get_nbins_correlation(self) -> int:
        ...


class ConcatDataset:
    """Random-access concatenation of map-style datasets."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cum: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cum.append(total)

    def __len__(self) -> int:
        return self.cum[-1]

    def _locate(self, index: int):
        if index < 0:
            index += len(self)
        assert 0 <= index < len(self), index
        ds_idx = bisect.bisect_right(self.cum, index)
        prev = self.cum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx], index - prev

    def __getitem__(self, index: int):
        dataset, i = self._locate(index)
        return dataset[i]

    def get_item(self, index: int, rng):
        """The item drawn with an explicit rng, where the member dataset
        takes one: the Loader's per-item seeding reaches the items through
        the concatenation (the JAX package's ConcatDataset has no
        get_item, so its Loader draws DSEC augmentation unseeded)."""
        dataset, i = self._locate(index)
        get_item = getattr(dataset, "get_item", None)
        return get_item(i, rng) if get_item is not None else dataset[i]
