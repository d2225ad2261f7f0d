"""The port's worker-process loader (`hardware.loader=grain`,
bflow_tpu_torch/data/grain_loader.py) against the JAX package's Grain
loader (bflow_tpu/data/grain_loader.py, in-process: num_workers=0) and
against the port's threaded Loader.

Grain shuffles with its own algorithm; the port's loader keeps the
threaded Loader's order and per-item RNG. So against Grain the length per
process shard, the head batch (`peek`) and the unshuffled batches of a
dataset that draws no randomness are bit-equal; the shuffled shards form a
disjoint cover of each epoch; and against the threaded Loader every batch
is bit-equal, augmentation included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bflow_tpu_torch.data.loader import Loader, make_loader
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

N_ITEMS = 11


class Items:
    """Items in the JAX layouts (IMG and MultiFlow FLOW keep a leading
    stack axis; a nested dict of metadata), drawn from the item's RNG
    unless ``fixed``."""

    def __init__(self, fixed: bool = False):
        self.fixed = fixed

    def __len__(self) -> int:
        return N_ITEMS

    def get_item(self, index: int, rng: np.random.Generator):
        noise = (np.zeros if self.fixed else
                 lambda s: rng.standard_normal(s).astype(np.float32))
        return {
            "ev_repr": np.full((4, 5, 3), float(index), np.float32)
            + noise((4, 5, 3)),
            "img": np.full((2, 4, 5, 3), float(index), np.float32)
            + noise((2, 4, 5, 3)),
            "flow": np.full((3, 4, 5, 2), float(index), np.float32)
            + noise((3, 4, 5, 2)),
            "flow_valid": np.arange(20).reshape(4, 5) % (index + 2) == 0,
            "meta": {"index": np.asarray(index)},
        }


def _ids(batch) -> list:
    return batch["meta"]["index"].tolist()


def _assert_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_equal(got[k], w, f"{where}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(w)
            assert g.dtype == w.dtype, f"{where}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")


def _jax_loader(dataset, **kw):
    from bflow_tpu.data.grain_loader import make_grain_loader

    return make_grain_loader(dataset, num_workers=0, **kw)


@pytest.mark.parametrize("processes", [1, 2, 3])
def test_len_per_shard_and_peek_match_grain(monkeypatch, processes):
    import jax

    monkeypatch.setattr(jax, "process_count", lambda: processes)
    want = _jax_loader(Items(), batch_size=2, shuffle=True, seed=4)
    shards = [make_loader(Items(), "grain", batch_size=2, shuffle=True,
                          seed=4, num_workers=1, shard=(r, processes))
              for r in range(processes)]
    for got in shards:
        assert len(got) == len(want) == N_ITEMS // processes // 2
        _assert_equal(got.peek(), want.peek())


def test_unshuffled_batches_match_grain():
    want = list(_jax_loader(Items(fixed=True), batch_size=3, shuffle=False,
                            shard_by_process=False))
    got = list(make_loader(Items(fixed=True), "grain", batch_size=3,
                           shuffle=False, num_workers=2).iterate())
    assert len(got) == len(want) == N_ITEMS // 3
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal(g, w, f"batch {i}")


def test_shuffled_shards_cover_each_epoch_disjointly():
    loaders = [make_loader(Items(), "grain", batch_size=2, shuffle=True,
                           seed=1, num_workers=2, shard=(r, 2))
               for r in range(2)]
    orders = []
    for epoch in range(2):
        ids = []
        for loader in loaders:
            loader.set_epoch(epoch)
            ids.append([i for b in loader.iterate() for i in _ids(b)])
        assert not set(ids[0]) & set(ids[1])
        assert len(ids[0]) == len(ids[1]) == (N_ITEMS // 2) // 2 * 2
        orders.append(ids)
    assert orders[0] != orders[1]  # reshuffled per epoch


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_batches_bit_equal_to_threaded_loader(shard):
    """Shuffled, augmented (per-item RNG) batches over two epochs, a pass
    from batch 1 (a resumed epoch), as tensors on the device."""
    kw = dict(batch_size=2, shuffle=True, seed=7, shard=shard,
              device="cpu")
    got_loader = make_loader(Items(), "grain", num_workers=2, **kw)
    want_loader = Loader(Items(), num_workers=3, **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in (0, 3):
        for loader in (got_loader, want_loader):
            loader.set_epoch(epoch)
        got = list(got_loader.iterate(1, None))
        want = list(want_loader.iterate(1, None))
        assert len(got) == len(want) == len(want_loader) - 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert isinstance(g["img"], torch.Tensor)
            _assert_equal(g, w, f"epoch {epoch} batch {i}")
        assert got_loader.wait_s > 0.0
