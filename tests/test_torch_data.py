"""Port parity of the data layer (bflow_tpu_torch.data vs bflow_tpu.data) on
the fabricated DSEC recordings of tests/fixtures.py at 32x48.

Everything here is bit-equal: host voxel grids and their normalization,
event windows, flow PNG decoding, voxel caches written by either package
and read by the other, DsecProvider items (val split, train split with
augmentation under the same rng, test split; the recording has a
timestamp gap), and Loader batches for a (seed, epoch) under shuffle,
drop_last, shard, peek and any worker count. The port's own HDF5 reader
and writer (bflow_tpu_torch/data/hdf5.py, used where h5py is missing) are
held to h5py's reads of the same files.
"""

from __future__ import annotations

import bisect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bflow_tpu.data import io as jio
from bflow_tpu.data import representations as jrep
from bflow_tpu.data.dsec.provider import DsecProvider as JaxDsecProvider
from bflow_tpu.data.eventslicer import EventSlicer as JaxEventSlicer
from bflow_tpu.data.loader import Loader as JaxLoader
from bflow_tpu_torch.data import hdf5
from bflow_tpu_torch.data import io as tio
from bflow_tpu_torch.data import representations as trep
from bflow_tpu_torch.data.dsec.provider import DsecProvider
from bflow_tpu_torch.data.eventslicer import EventSlicer
from bflow_tpu_torch.data.loader import Loader
from fixtures import encode_flow_png, make_dsec_sequence
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

HW = (32, 48)


@pytest.fixture(params=["h5py", "builtin"])
def backend(request, monkeypatch):
    """The port's HDF5 access: through h5py, or its own reader and writer
    (as on a machine without h5py)."""
    if request.param == "builtin":
        monkeypatch.setattr(hdf5, "h5py", None)
    return request.param


def assert_items_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert_items_equal(g, w, f"{where}/{key}")
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}/{key}")


def dsec_params(root, load_voxel_grid=False):
    return {"path": str(root), "load_voxel_grid": load_voxel_grid,
            "extended_voxel_grid": True, "normalize_voxel_grid": True,
            "height": HW[0], "width": HW[1], "crop_hw": (16, 24)}


@pytest.fixture
def dsec_root(tmp_path):
    """Train: one recording of 6 windows with a gap after the 3rd, one of
    3. Test: one recording of 3 windows."""
    train = tmp_path / "train"
    train.mkdir()
    make_dsec_sequence(train, "seq_a", n_flows=6, height=HW[0], width=HW[1],
                       gap_after=3, seed=1)
    make_dsec_sequence(train, "seq_b", n_flows=3, height=HW[0], width=HW[1],
                       seed=2)
    test = tmp_path / "test"
    test.mkdir()
    make_dsec_sequence(test, "seq_t", n_flows=3, height=HW[0], width=HW[1],
                       seed=3)
    return tmp_path


# ---------------------------------------------------------------- host grids

@pytest.mark.parametrize("int_xy", [True, False])
def test_voxel_grid_bit_equal(int_xy):
    rng = np.random.default_rng(11)
    ch, ht, wd, n = 7, 24, 30, 5000
    t = np.sort(rng.integers(1_000_000, 1_200_000, n)).astype(np.int64)
    pol = rng.integers(0, 2, n).astype(np.float32)
    if int_xy:
        x = rng.integers(0, wd, n).astype(np.int64)
        y = rng.integers(0, ht, n).astype(np.int64)
    else:
        x = rng.uniform(-0.7, wd - 0.3, n).astype(np.float32)
        y = rng.uniform(-0.7, ht - 0.3, n).astype(np.float32)
    for window in ((None, None), (1_020_000, 1_180_000)):
        want = jrep.VoxelGrid(ch, ht, wd).convert(x, y, pol, t, *window)
        got = trep.VoxelGrid(ch, ht, wd).convert(x, y, pol, t, *window)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            trep.normalize_voxel_grid(got.copy()),
            jrep.normalize_voxel_grid(want.copy()))
    g = trep.VoxelGrid(ch, ht, wd)
    j = jrep.VoxelGrid(ch, ht, wd)
    assert (g.get_extended_time_window(1_000_000, 1_100_000)
            == j.get_extended_time_window(1_000_000, 1_100_000))


def test_normalize_constant_and_empty():
    for arr in (np.zeros((3, 4, 5), np.float32),
                np.full((3, 4, 5), 2.5, np.float32)):
        np.testing.assert_array_equal(trep.normalize_voxel_grid(arr.copy()),
                                      jrep.normalize_voxel_grid(arr.copy()))


# ---------------------------------------------------------------- slicing, io

def test_event_slicer_windows_equal(tmp_path, backend):
    import h5py

    seq = make_dsec_sequence(tmp_path, "s", n_flows=4, height=HW[0],
                             width=HW[1], seed=5)
    path = seq / "events" / "left" / "events.h5"
    with h5py.File(str(path), "r") as jf, hdf5.open_file(path) as tf:
        js, ts = JaxEventSlicer(jf), EventSlicer(tf)
        assert ts.get_start_time_us() == js.get_start_time_us()
        assert ts.get_final_time_us() == js.get_final_time_us()
        t0 = js.get_start_time_us()
        for lo, hi in ((0, 100_000), (150_500, 250_250), (37, 38_001),
                       (90_000, 460_000), (10**9, 10**9 + 1)):
            want = js.get_events(t0 + lo, t0 + hi)
            got = ts.get_events(t0 + lo, t0 + hi)
            if want is None:
                assert got is None
                continue
            assert_items_equal(got, want, f"[{lo}, {hi})")


def test_flow_png_round_trip_equal(tmp_path):
    rng = np.random.default_rng(4)
    flow = rng.uniform(-200, 200, (*HW, 2)).astype(np.float32)
    valid = rng.random(HW) > 0.3
    path = tmp_path / "000002.png"
    encode_flow_png(path, flow, valid)
    got, got_valid = tio.load_flow_png(path)
    want, want_valid = jio.load_flow_png(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert np.abs(got[valid] - flow[valid]).max() <= 1 / 128  # truncation


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_voxel_cache_cross_read(tmp_path, backend, writer, record_property):
    """A cache written by either package reads back bit-equal in the
    other (the port through h5py or its own HDF5 reader and writer)."""
    rng = np.random.default_rng(6)
    grid = rng.standard_normal((9, *HW)).astype(np.float32)
    grid[:, ::3] = 0.0
    path = tmp_path / "000004.h5"
    codec = {"jax": "blosc-zstd" if jio._native_blosc() else "gzip",
             "port": tio.cache_codec()}[writer]
    record_property("codec", f"{writer} wrote {codec}, port via {backend}")
    print(f"cache codec: {writer} wrote {codec}; the port read or wrote "
          f"through {backend}")
    if writer == "jax":
        jio.np_array_to_h5(grid, path)
        got = tio.h5_to_np_array(path)
    else:
        tio.np_array_to_h5(grid, path)
        got = jio.h5_to_np_array(path)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, grid)
    np.testing.assert_array_equal(tio.h5_to_np_array(path), grid)
    assert not list(tmp_path.glob("*.tmp*"))  # the write was atomic


def test_blosc_codec_is_the_ports_own():
    """The port builds its codec from native/blosc_codec.cpp into its own
    build directory and never loads a library from native/; where it
    builds, its chunks decode in the JAX package's codec and back."""
    from bflow_tpu.data import blosc_native as jbn
    from bflow_tpu_torch.data import blosc_native as tbn

    root = Path(tbn.__file__).resolve().parents[2]
    assert tbn.SOURCE == root / "native" / "blosc_codec.cpp"
    assert tbn.library_path().parent == root / "bflow_tpu_torch" / "build"
    if not (tbn.available() and jbn.available()):
        pytest.skip("the native codec does not build here")
    assert Path(tbn._lib._name).parent == root / "bflow_tpu_torch" / "build"
    arr = np.random.default_rng(3).standard_normal(70_000).astype(np.float32)
    for enc, dec in ((tbn, jbn), (jbn, tbn)):
        out = dec.decompress(enc.compress(arr), arr.nbytes)
        np.testing.assert_array_equal(np.frombuffer(out, np.float32), arr)


def test_corrupt_cache_reads_as_none(tmp_path, backend):
    path = tmp_path / "000000.h5"
    path.write_bytes(b"\x89HDF\r\n\x1a\nnot really")
    assert tio.h5_to_np_array(path) is None
    assert tio.h5_to_np_array(tmp_path / "missing.h5") is None


def test_builtin_hdf5_matches_h5py(tmp_path):
    """The port's own writer's files read back the same through h5py, and
    h5py's files (contiguous, chunked with gzip, shuffle and Fletcher-32,
    scalars, nested groups) through the port's reader."""
    import h5py

    rng = np.random.default_rng(8)
    arrays = {
        "events/t": np.sort(rng.integers(0, 10**6, 3000)).astype(np.uint32),
        "events/x": rng.integers(0, 640, 3000).astype(np.uint16),
        "events/p": rng.integers(0, 2, 3000).astype(np.uint8),
        "ms_to_idx": np.arange(70, dtype=np.int64),
        "t_offset": np.int64(123456789),
        "rectify_map": rng.standard_normal((6, 7, 2)).astype(np.float32),
        "f8": rng.standard_normal(5),
        "i2": rng.integers(-9, 9, (4, 3)).astype(np.int16),
    }
    for level in (None, 1):
        path = tmp_path / f"ours{level}.h5"
        hdf5.write_file(path, arrays, level)
        with h5py.File(str(path), "r") as hf, hdf5.File(path) as of:
            for name, arr in arrays.items():
                for got in (hf[name][()], of[name][()]):
                    assert np.shape(got) == arr.shape, name
                    assert np.asarray(got).dtype == arr.dtype, name
                    np.testing.assert_array_equal(got, arr, err_msg=name)
            np.testing.assert_array_equal(of["events/t"][100:2100],
                                          arrays["events/t"][100:2100])
            assert of["events/t"][-1] == arrays["events/t"][-1]
    path = tmp_path / "h5py.h5"
    with h5py.File(str(path), "w") as hf:
        for name, arr in arrays.items():
            hf.create_dataset(name, data=arr)
        hf.create_dataset("gz", data=rng.standard_normal((9, 40, 50)).astype(
            np.float32), compression="gzip", compression_opts=1)
        hf.create_dataset("filtered", data=rng.standard_normal(5000).astype(
            np.float32), chunks=(256,), compression="gzip", shuffle=True,
            fletcher32=True)
        for i in range(40):  # several symbol-table nodes
            hf.create_dataset(f"many/d{i:02d}", data=np.int64(i))
    with h5py.File(str(path), "r") as hf, hdf5.File(path) as of:
        names = (list(arrays) + ["gz", "filtered"]
                 + [f"many/d{i:02d}" for i in range(40)])
        for name in names:
            np.testing.assert_array_equal(of[name][()], hf[name][()],
                                          err_msg=name)
        np.testing.assert_array_equal(of["filtered"][1000:3333],
                                      hf["filtered"][1000:3333])
        assert sorted(of["many"].keys()) == sorted(hf["many"].keys())


# ---------------------------------------------------------------- providers

class SeededConcat:
    """A JAX ConcatDataset that passes the Loader's per-item rng on to its
    members, as the port's ConcatDataset does (the JAX one has no
    get_item, so its Loader draws DSEC augmentation unseeded)."""

    def __init__(self, concat):
        self.concat = concat

    def __len__(self):
        return len(self.concat)

    def get_item(self, index, rng):
        ds = self.concat
        while hasattr(ds, "cum"):  # nested ConcatDatasets
            k = bisect.bisect_right(ds.cum, index)
            index -= ds.cum[k - 1] if k else 0
            ds = ds.datasets[k]
        return ds.get_item(index, rng)


def _items(dataset, seed):
    return [dataset.get_item(i, np.random.default_rng(seed + i))
            for i in range(len(dataset))]


@pytest.mark.parametrize("split", ["val", "val_cached", "train_augmented",
                                   "test"])
def test_dsec_provider_items_equal(dsec_root, tmp_path, backend, split):
    cached = split == "val_cached"
    if cached:
        # no gap here: the fixture names flow files 0, 2, 4, ... across a
        # gap, so the synthesized window before a gap would share its
        # cache file name with the window before it (real DSEC file
        # indices jump at a gap)
        dsec_root = tmp_path / "cached"
        for name, n in (("seq_b", 3), ("seq_c", 6)):
            make_dsec_sequence(dsec_root / "train", name, n_flows=n,
                               height=HW[0], width=HW[1], seed=n)
    tp = DsecProvider(dsec_params(dsec_root, cached), 5)
    jp = JaxDsecProvider(dsec_params(dsec_root, cached), 5)
    assert tp.get_nbins_context() == jp.get_nbins_context() == 5
    assert tp.get_nbins_correlation() == jp.get_nbins_correlation()
    if split == "test":
        tseqs = list(tp.iter_test_sequences())
        jseqs = list(jp.iter_test_sequences())
        assert [n for n, _ in tseqs] == [n for n, _ in jseqs] == ["seq_t"]
        pairs = [(tseqs[0][1], jseqs[0][1])]
        assert "flow" not in tseqs[0][1][0]
    elif split == "train_augmented":
        pairs = [(tp.get_train_dataset(), jp.get_train_dataset())]
    else:
        pairs = [(tp.get_val_dataset(), jp.get_val_dataset())]
    for tds, jds in pairs:
        assert len(tds) == len(jds) == (3 if split == "test" else 9)
        # the port first: with caches on, it writes them and the JAX
        # provider reads them back
        got = _items(tds, 100)
        want = _items(SeededConcat(jds), 100)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, f"{split} item {i}")
        if split == "train_augmented":
            assert got[0]["ev_repr"].shape == (16, 24, 9)
        else:
            assert got[0]["ev_repr"].shape == (*HW, 9)
    if cached:
        caches = sorted(dsec_root.glob("train/*/events/left/voxel_grids_*/*"))
        assert len(caches) == 9 + 2  # current windows + first-window pads


# ---------------------------------------------------------------- loader

@pytest.mark.parametrize("shuffle,drop_last,shard,workers", [
    (True, True, None, 3),
    (True, False, (1, 2), 1),
    (False, False, (0, 3), 2),
])
def test_loader_batches_equal(dsec_root, shuffle, drop_last, shard, workers):
    tds = DsecProvider(dsec_params(dsec_root), 5).get_train_dataset()
    jds = SeededConcat(
        JaxDsecProvider(dsec_params(dsec_root), 5).get_train_dataset())
    kw = dict(batch_size=2, shuffle=shuffle, seed=3, drop_last=drop_last,
              shard=shard)
    tl = Loader(tds, num_workers=workers, **kw)
    jl = JaxLoader(jds, num_workers=2, **kw)
    assert len(tl) == len(jl)
    assert_items_equal(tl.peek(), jl.peek(), "peek")
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for b, (g, w) in enumerate(zip(got, want)):
            assert g["img"].shape[:2] == (2, len(g["file_index"]))
            assert_items_equal(g, w, f"epoch {epoch} batch {b}")
    # the hand-off to a device: the same values as tensors
    tl.device = torch.device("cpu")
    tensors = list(tl)
    assert all(isinstance(v, torch.Tensor) for v in tensors[0].values())
    for b, (g, w) in enumerate(zip(tensors, want)):
        assert_items_equal(g, w, f"tensors batch {b}")


def test_loader_does_not_depend_on_workers(dsec_root):
    ds = DsecProvider(dsec_params(dsec_root), 5).get_train_dataset()
    runs = [list(Loader(ds, batch_size=3, shuffle=True, seed=9,
                        num_workers=n, drop_last=False)) for n in (1, 4)]
    for a, b in zip(*runs):
        assert_items_equal(a, b)


def test_loader_propagates_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(Loader(Broken(), batch_size=2, num_workers=2))
    with pytest.raises(RuntimeError, match="boom"):
        list(Loader(Broken(), batch_size=2, num_workers=2, device="cpu"))


def test_subsequence_pickles(dsec_root):
    """Worker processes receive a dataset by pickle: the open handle and
    the lock stay behind, and the copy reopens lazily."""
    import pickle

    ds = DsecProvider(dsec_params(dsec_root), 5).get_val_dataset()
    first = ds[0]
    clone = pickle.loads(pickle.dumps(ds))
    assert_items_equal(clone.get_item(0, np.random.default_rng(0)),
                       ds.get_item(0, np.random.default_rng(0)))
    assert sorted(first) == sorted(clone[0])


def test_threaded_loader_with_caches(tmp_path, backend):
    """Four loader threads writing, then reading the voxel caches give the
    uncached batches. With h5py and the blosc codec, the JAX package's
    cache IO under its threaded Loader fails (H5Dwrite_chunk errors, heap
    corruption: libhdf5's error stack is not thread-safe); the port holds
    one lock around h5py's cache IO (bflow_tpu_torch/data/io.py)."""
    root = tmp_path / "dsec"
    make_dsec_sequence(root / "train", "s", n_flows=9, height=HW[0],
                       width=HW[1], seed=7)

    def batches(cached):
        ds = DsecProvider(dsec_params(root, cached), 15).get_val_dataset()
        return list(Loader(ds, batch_size=4, num_workers=4, drop_last=False))

    want = batches(False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often
    try:
        runs = {run: batches(True) for run in ("writing", "reading")}
    finally:
        sys.setswitchinterval(interval)
    for run, got in runs.items():
        assert len(got) == len(want) == 3
        for b, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, f"{run} batch {b}")
