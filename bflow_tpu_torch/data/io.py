"""Dataset IO: 16-bit flow PNG decoding + compressed HDF5 voxel caches
(copy of bflow_tpu/data/io.py).

Cache compatibility: the reference writes voxel caches as blosc-zstd
HDF5 (filter id 32001). h5py has no blosc plugin, so:

  * READ: read the dataset directly (gzip/lzf/uncompressed); on a
    missing-filter error, fall back to the native blosc decoder
    (bflow_tpu_torch.data.blosc_native) reading raw chunks.
  * WRITE: gzip-1 caches (universally readable); with h5py and the
    native codec built, blosc-zstd byte-shuffle like the reference, so
    caches are interchangeable with it.

Without h5py, HDF5 goes through the port's own reader and writer
(bflow_tpu_torch/data/hdf5.py), which write gzip-1 caches. `cache_codec`
says which codec a write uses. Corrupt cache files return None and are
rebuilt by callers.

Threads: h5py serializes its calls, but libhdf5's error stack is not
thread-safe, and the blosc path makes errors on purpose (an unknown filter
on write, a missing one on read): under the threaded Loader the JAX
package's cache IO fails (`H5Dwrite_chunk` errors) or corrupts the heap.
Here every h5py access of the data layer (caches, events, flows) holds
one lock, `h5py_lock`: an event read in one thread while another thread's
cache IO raises its deliberate errors fails as well. Since h5py holds its
own global lock during the IO anyway, this costs no parallelism.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from bflow_tpu_torch.data import hdf5

_H5PY_CACHE_LOCK = threading.Lock()
BLOSC_FILTER_ID = 32001
# (0, 0, 0, 0, complevel=1, shuffle=byte(1), compressor=zstd(5))
BLOSC_ZSTD_OPTS = (0, 0, 0, 0, 1, 1, 5)


def flow_16bit_to_float(flow_16bit: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DSEC 16-bit PNG encoding: (v - 2^15) / 128, third channel = valid."""
    assert flow_16bit.dtype == np.uint16, flow_16bit.dtype
    assert flow_16bit.ndim == 3 and flow_16bit.shape[2] == 3
    valid = flow_16bit[..., 2] == 1
    assert np.all(flow_16bit[~valid, 2] == 0)
    flow = (flow_16bit[..., :2].astype(np.float32) - 2.0**15) / 128.0
    flow[~valid] = 0.0
    return flow, valid


def load_flow_png(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ((H, W, 2) float32 flow, (H, W) bool valid).

    Channels as stored in the PNG (DSEC: 0=x, 1=y, 2=valid). cv2 reads
    16-bit RGB PNGs in BGR order, so the read is reversed back to file
    order.
    """
    path = Path(path)
    assert path.suffix == ".png", path
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    assert raw is not None, path
    raw = raw[..., ::-1]  # BGR -> file (RGB) channel order
    return flow_16bit_to_float(raw)


def _native_blosc():
    try:
        from bflow_tpu_torch.data import blosc_native

        return blosc_native if blosc_native.available() else None
    except Exception:
        return None


def h5py_lock():
    """The data layer's lock where h5py does the IO (the module docstring):
    every h5py access of the events, flows and caches holds it."""
    if hdf5.h5py is None:
        return contextlib.nullcontext()
    return _H5PY_CACHE_LOCK


def cache_codec() -> str:
    """The codec that np_array_to_h5 writes here: 'blosc-zstd' (h5py and
    the native codec) or 'gzip'."""
    if hdf5.h5py is not None and _native_blosc() is not None:
        return "blosc-zstd"
    return "gzip"


def np_array_to_h5(array: np.ndarray, outpath: Union[str, Path]) -> None:
    """Write a voxel cache file (dataset name 'voxel_grid').

    Atomic: writes a private tmp file and os.replace()s it into place.
    Concurrent loader workers build neighbouring items whose windows
    share cache files; an in-place write would let a reader open a
    half-written file that still parses. With the rename, readers see
    either the complete file or no file (then rebuild); racing writers
    both produce identical bytes and the last rename wins."""
    outpath = Path(outpath)
    assert outpath.suffix == ".h5"
    tmppath = outpath.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.h5")
    with h5py_lock():
        if cache_codec() == "blosc-zstd":
            nat = _native_blosc()
            with hdf5.h5py.File(str(tmppath), "w") as h5f:
                # Reference-identical blosc-zstd cache.
                ds = h5f.create_dataset(
                    "voxel_grid",
                    shape=array.shape,
                    dtype=array.dtype,
                    chunks=array.shape,
                    compression=BLOSC_FILTER_ID,
                    compression_opts=BLOSC_ZSTD_OPTS,
                    allow_unknown_filter=True,
                )
                comp = nat.compress(np.ascontiguousarray(array))
                ds.id.write_direct_chunk((0,) * array.ndim, comp)
        else:
            hdf5.write_arrays(tmppath, {"voxel_grid": array}, gzip_level=1)
    os.replace(tmppath, outpath)


def h5_to_np_array(inpath: Union[str, Path]) -> Optional[np.ndarray]:
    """Read a voxel cache; None when the file is corrupt/unreadable."""
    inpath = Path(inpath)
    assert inpath.suffix == ".h5"
    if not inpath.exists():
        return None
    try:
        with h5py_lock(), hdf5.open_file(inpath) as h5f:
            ds = h5f["voxel_grid"]
            try:
                return np.asarray(ds)
            except Exception:
                if hdf5.h5py is None:
                    return None
                return _read_blosc_dataset(ds)
    except (OSError, KeyError):
        return None


def _read_blosc_dataset(ds) -> Optional[np.ndarray]:
    """Raw-chunk read through h5py + native blosc decode (reference
    caches)."""
    nat = _native_blosc()
    if nat is None:
        return None
    try:
        if ds.chunks is None:
            return None
        out = np.empty(ds.shape, dtype=ds.dtype)
        chunk = ds.chunks
        grid = [range(0, s, c) for s, c in zip(ds.shape, chunk)]
        for corner in itertools.product(*grid):
            _, payload = ds.id.read_direct_chunk(corner)
            sel = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(corner, chunk, ds.shape)
            )
            shape = tuple(sl.stop - sl.start for sl in sel)
            n = int(np.prod(chunk))
            block = nat.decompress(payload, n * ds.dtype.itemsize)
            if block is None:
                return None
            arr = np.frombuffer(block, dtype=ds.dtype)[:n].reshape(chunk)
            out[sel] = arr[tuple(slice(0, s) for s in shape)]
        return out
    except Exception:
        return None
