"""Port parity of the MultiFlow data layer (bflow_tpu_torch.data.multiflow2d
and the Loader over it vs bflow_tpu.data.multiflow2d) on the fabricated
samples of tests/fixtures.py at 32x48 (crop 16x24).

Everything here is bit-equal: Datasubset items under the same rng, without
augmentation, with the flip and crop augmentation, with the photometric
augmentation and with `downsample`; collated Loader batches for a (seed,
epoch), peek included, with MultiFlow's flow stacked (M, N, H, W, 2);
voxel caches written by either package and read by the other; frames read
through cv2 equal imageio's RGB arrays (a BGR swap shows at random
pixels). The port's HDF5 access runs through h5py and through its own
reader (as on a machine without h5py).
"""

from __future__ import annotations

import numpy as np
import pytest

from bflow_tpu.data.loader import Loader as JaxLoader
from bflow_tpu.data.multiflow2d.provider import (
    MultiflowProvider as JaxMultiflowProvider,
)
from bflow_tpu_torch import cli
from bflow_tpu_torch.data import hdf5
from bflow_tpu_torch.data.loader import Loader, make_loader
from bflow_tpu_torch.data.multiflow2d import sample as tsample
from bflow_tpu_torch.data.multiflow2d.provider import MultiflowProvider
from fixtures import make_multiflow_sample
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_data import assert_items_equal

HW, CROP = (32, 48), (16, 24)


@pytest.fixture(params=["h5py", "builtin"])
def backend(request, monkeypatch):
    if request.param == "builtin":
        monkeypatch.setattr(hdf5, "h5py", None)
    return request.param


@pytest.fixture
def mf_root(tmp_path):
    """Train: 3 samples, val: 2; 6 context bins."""
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            make_multiflow_sample(tmp_path / split, f"seq_{i:04d}",
                                  height=HW[0], width=HW[1],
                                  n_events=4000, seed=7 * i + len(split))
    return tmp_path


def mf_params(root, **kw):
    return {"path": str(root), "load_voxel_grid": False,
            "normalize_voxel_grid": True, "extended_voxel_grid": True,
            "flow_every_n_ms": 50, "downsample": False, "photo_augm": False,
            "orig_hw": HW, "crop_hw": CROP, **kw}


CASES = {
    "val": ("val", {}),
    "val_every_100ms": ("val", {"flow_every_n_ms": 100}),
    "train_augmented": ("train", {}),
    "train_photo_augm": ("train", {"photo_augm": True}),
    "train_downsample": ("train", {"downsample": True}),
    "val_unnormalized_v0": ("val", {"normalize_voxel_grid": False,
                                    "extended_voxel_grid": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_items_equal(mf_root, backend, case):
    split, kw = CASES[case]
    tp = MultiflowProvider(mf_params(mf_root, **kw), 6)
    jp = JaxMultiflowProvider(mf_params(mf_root, **kw), 6)
    assert tp.get_nbins_context() == jp.get_nbins_context() == 6
    assert tp.get_nbins_correlation() == jp.get_nbins_correlation() == 4
    tds = tp.get_train_dataset() if split == "train" else tp.get_val_dataset()
    jds = jp.get_train_dataset() if split == "train" else jp.get_val_dataset()
    assert len(tds) == len(jds) == (3 if split == "train" else 2)
    for i in range(len(tds)):
        got = tds.get_item(i, np.random.default_rng(100 + i))
        want = jds.get_item(i, np.random.default_rng(100 + i))
        assert_items_equal(got, want, f"{case} item {i}")
    m = 500 // kw.get("flow_every_n_ms", 50)
    h, w = HW if split == "val" else CROP
    if kw.get("downsample"):
        h, w = h // 2, w // 2
    assert got["flow"].shape == (m, h, w, 2)
    assert got["ev_repr"].shape == (h, w, 6 + 4 - 1)
    assert got["img"].shape == (2, h, w, 3)
    np.testing.assert_array_equal(
        np.asarray(cli.supervision_timestamps(tds), np.float32),
        got["flow_timestamps"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_voxel_cache_cross_read(mf_root, backend, writer):
    """Caches written by one package are read back by the other: the same
    items, from the same file names."""
    params = mf_params(mf_root, load_voxel_grid=True)
    tds = MultiflowProvider(params, 6).get_val_dataset()
    jds = JaxMultiflowProvider(params, 6).get_val_dataset()
    first, second = (tds, jds) if writer == "port" else (jds, tds)
    wrote = [first.get_item(i, np.random.default_rng(i))
             for i in range(len(first))]
    caches = sorted(mf_root.glob("val/*/events/voxel_grid_v1_9_bins.h5"))
    assert len(caches) == 2
    read = [second.get_item(i, np.random.default_rng(i))
            for i in range(len(second))]
    for i, (g, w) in enumerate(zip(read, wrote)):
        assert_items_equal(g, w, f"item {i}")
    uncached = JaxMultiflowProvider(mf_params(mf_root), 6).get_val_dataset()
    assert_items_equal(read[0], uncached.get_item(0, np.random.default_rng(0)))


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (True, True, 2),
    (False, False, 1),
])
def test_loader_batches_equal(mf_root, shuffle, drop_last, workers):
    tds = MultiflowProvider(mf_params(mf_root), 6).get_train_dataset()
    jds = JaxMultiflowProvider(mf_params(mf_root), 6).get_train_dataset()
    kw = dict(batch_size=2, shuffle=shuffle, seed=5, drop_last=drop_last)
    tl = make_loader(tds, kind="threaded", num_workers=workers, **kw)
    jl = JaxLoader(jds, num_workers=2, **kw)
    assert isinstance(tl, Loader) and len(tl) == len(jl)
    assert_items_equal(tl.peek(), jl.peek(), "peek")
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for b, (g, w) in enumerate(zip(got, want)):
            n = len(g["dataset_type"])
            assert g["flow"].shape == (10, n, *CROP, 2)
            assert g["img"].shape == (2, n, *CROP, 3)
            assert_items_equal(g, w, f"epoch {epoch} batch {b}")
    # the resumed epoch: batches from an offset, bounded, are those batches
    tl.set_epoch(1)
    for b, g in enumerate(tl.iterate(1, 2), start=1):
        assert_items_equal(g, want[b], f"iterate from 1, batch {b}")


def test_loader_early_break_releases_producer(mf_root):
    """A consumer that breaks off leaves no producer thread blocked on the
    full queue."""
    import threading
    import time

    tds = MultiflowProvider(mf_params(mf_root), 6).get_train_dataset()
    before = threading.active_count()
    loader = Loader(tds, batch_size=1, num_workers=1, prefetch_batches=1)
    for _ in loader:
        time.sleep(0.3)  # the producer fills the queue and waits
        break
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_grain_loader_batches_equal_threaded(mf_root, backend):
    """hardware.loader=grain: MultiFlow items, augmented (flip, crop and
    photometric) and with their nested metadata, loaded in worker
    processes from the pickled dataset, collate to the threaded Loader's
    batches bit for bit, per process shard."""
    tds = MultiflowProvider(mf_params(mf_root, photo_augm=True),
                            6).get_train_dataset()
    for shard in (None, (1, 2)):
        kw = dict(batch_size=1, shuffle=True, seed=5, shard=shard)
        grain = make_loader(tds, kind="grain", num_workers=2, **kw)
        threaded = make_loader(tds, kind="threaded", num_workers=2, **kw)
        for loader in (grain, threaded):
            loader.set_epoch(2)
        got, want = list(grain.iterate()), list(threaded.iterate())
        assert len(got) == len(want) == len(tds) // (shard or (0, 1))[1]
        for g, w in zip(got, want):
            assert_items_equal(g, w)
    with pytest.raises(ValueError, match="unknown loader kind"):
        make_loader(tds, kind="multiprocess", batch_size=1)


def test_frames_read_as_imageio_rgb(mf_root):
    import imageio.v2 as iio

    paths = sorted(mf_root.glob("*/*/images/*.png"))
    assert len(paths) == 10
    for p in paths:
        want = np.asarray(iio.imread(str(p)))
        got = tsample.read_rgb(p)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(p))
        # the check has teeth: the channels differ, so BGR would not pass
        assert not np.array_equal(got[..., ::-1], want)


def test_sample_tables_and_window_match_jax(mf_root):
    from bflow_tpu.data.multiflow2d import sample as jsample

    assert tsample.NBINS_CONTEXT2CORR == jsample.NBINS_CONTEXT2CORR
    assert tsample.NBINS_CONTEXT2DT_US == jsample.NBINS_CONTEXT2DT_US
    for nbins in sorted(tsample.NBINS_CONTEXT2CORR):
        path = mf_root / "val" / "seq_0000"
        ts = tsample.Sample(path, *HW, nbins)
        js = jsample.Sample(path, *HW, nbins)
        for attr in ("num_bins_total", "bin_0_time", "bin_target_time",
                     "img_ts", "flow_ts_us", "voxel_grid_file"):
            assert getattr(ts, attr) == getattr(js, attr), (nbins, attr)
        assert (ts.voxel_grid_bin_idx_for_reference()
                == js.voxel_grid_bin_idx_for_reference())


def test_threaded_loader_with_caches(mf_root, backend):
    """Six loader threads writing, then reading the voxel caches give the
    uncached batches. With h5py and the blosc codec, libhdf5's error stack
    is not thread-safe: the port holds one lock around every h5py access
    of the data layer (bflow_tpu_torch/data/io.py:h5py_lock), the
    events' and flows' as well as the caches'."""
    import sys

    def batches(cached):
        ds = MultiflowProvider(mf_params(mf_root, load_voxel_grid=cached),
                               6).get_train_dataset()
        return list(Loader(ds, batch_size=3, num_workers=6, shuffle=True))

    want = batches(False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often
    try:
        runs = {run: batches(True) for run in ("writing", "reading")}
    finally:
        sys.setswitchinterval(interval)
    assert len(list(mf_root.glob("train/*/events/voxel_grid_*.h5"))) == 3
    for run, got in runs.items():
        assert len(got) == len(want) == 1
        assert_items_equal(got[0], want[0], run)
