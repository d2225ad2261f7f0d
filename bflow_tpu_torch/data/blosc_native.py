"""ctypes bindings for the native blosc codec (counterpart of
bflow_tpu/data/blosc_native.py).

The port builds its own shared library from the repository's
``native/blosc_codec.cpp`` (read, never written) with g++ and the system
libzstd, on first use, into the package's ``build/`` directory, named by a
digest of the source. Every entry point degrades as the JAX package's
does: without the toolchain or libzstd's headers, `available()` is False
and the callers write gzip caches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "blosc_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libbflow_blosc-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", str(SOURCE),
             "-o", str(tmp), "-lzstd"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.is_file():
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.bflow_blosc_decompress.restype = ctypes.c_long
        lib.bflow_blosc_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.bflow_blosc_compress.restype = ctypes.c_long
        lib.bflow_blosc_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def decompress(payload: bytes, dst_nbytes: int) -> Optional[bytes]:
    lib = _get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(dst_nbytes)
    got = lib.bflow_blosc_decompress(
        payload, len(payload), out, dst_nbytes
    )
    if got < 0:
        return None
    return out.raw[:got]


def compress(arr: np.ndarray, clevel: int = 1) -> bytes:
    lib = _get_lib()
    assert lib is not None
    arr = np.ascontiguousarray(arr)
    n = arr.nbytes
    cap = n + 16 + 4 * (n // (256 * 1024) + 2) + 1024
    out = ctypes.create_string_buffer(cap)
    got = lib.bflow_blosc_compress(
        arr.ctypes.data_as(ctypes.c_void_p), n, out, cap,
        arr.dtype.itemsize, clevel,
    )
    assert got > 0, "blosc compression failed"
    return out.raw[:got]
