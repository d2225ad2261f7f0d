"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface, named by a digest of its source and flags, under the package's
``build/`` directory (listed in .gitignore). Sources that need building are
compiled in parallel, one nvcc per source. Nothing happens at import time:
the CPU tests import this module on machines without nvcc.

    python -m bflow_tpu_torch.kernels.build   # build every kernel, print times
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# kernel name -> source file under csrc/ (which may include csrc/*.cuh)
SOURCES = {"corr_lookup_fwd": "corr_lookup_fwd.cu",
           "corr_lookup_bwd": "corr_lookup_bwd.cu",
           "conv3x3": "conv3x3.cu",
           "stem_conv": "stem_conv.cu",
           "norm": "norm.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # the shared headers
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns, per
    kernel, its library path, the build seconds (0 when it was already
    built) and nvcc's register/shared-memory report."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                report[name] = {"path": str(out), "seconds": 0.0,
                                "ptxas": ""}
                continue
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)  # atomic: a reader never sees half a file
            report[name] = {"path": str(out),
                            "seconds": time.perf_counter() - t0,
                            "ptxas": log.strip()}
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel ``name``'s library, with its
    argument types set; it returns a CUDA error code."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, device, *args) -> None:
    """Call a kernel's C function on ``device``'s current stream (passed
    last) and raise on the cudaGetLastError() it returns."""
    import torch

    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


if __name__ == "__main__":
    for kname, info in build().items():
        print(f"{kname}: {info['seconds']:.1f} s -> {info['path']}")
        if info["ptxas"]:
            print(info["ptxas"])
