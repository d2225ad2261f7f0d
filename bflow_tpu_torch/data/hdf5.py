"""HDF5 access for the data layer: h5py where it is installed, else a small
reader and writer of the file format's classic subset.

DSEC ships its events, rectification maps and (the reference's) voxel
caches as HDF5. A machine without h5py still reads and writes them here,
through the subset of the format that h5py writes by default (the
"earliest" library version): superblock version 0 or 1, version-1 object
headers (continuation blocks included), symbol-table groups (version-1
B-trees over a local heap), simple and scalar dataspaces, integer and
IEEE float datatypes, and contiguous, compact or chunked storage, whose
chunks may carry the deflate, shuffle and Fletcher-32 filters, and the
blosc filter (id 32001) when the native codec is built
(``blosc_native``). The writer emits contiguous datasets, or one
deflate-compressed chunk per dataset, in the same structure; h5py reads
its files. Files of the newer format versions (h5py's ``libver='latest'``)
are refused with an error that says so.

    with open_file(path) as f:            # h5py.File or File, read-only
        t = f["events/t"][lo:hi]          # reads only those rows
    write_arrays(path, {"events/t": t, "t_offset": np.int64(0)})
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # File and write_file below take its place
    h5py = None

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
_GROUP_LEAF_K = 4  # symbol-table node: up to 2K entries
_GROUP_NODE_K = 16  # group B-tree node: up to 2K children
_CHUNK_NODE_K = 32  # chunk B-tree node (the format's default)
_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER, _FILTER_BLOSC = (
    1, 2, 3, 32001)


def open_file(path):
    """Open an HDF5 file for reading: h5py's File where h5py is
    installed, else this module's."""
    if h5py is not None:
        return h5py.File(str(path), "r")
    return File(path)


def write_arrays(path, arrays: Mapping[str, np.ndarray],
                 gzip_level: Optional[int] = None) -> None:
    """Write named arrays (a '/' in a name makes groups), each one
    deflate-compressed chunk at ``gzip_level`` or contiguous without."""
    if h5py is None:
        write_file(path, arrays, gzip_level)
        return
    with h5py.File(str(path), "w") as h5f:
        for name, arr in arrays.items():
            if gzip_level is None:
                h5f.create_dataset(name, data=arr)
            else:
                h5f.create_dataset(name, data=arr, compression="gzip",
                                   compression_opts=gzip_level)


class FormatError(OSError):
    """The file is not HDF5, is cut short, or uses a part of the format
    this reader does not cover."""


# ---------------------------------------------------------------------------
# reading


def _u(fmt: str, buf: bytes, off: int = 0):
    return struct.unpack_from("<" + fmt, buf, off)


class File:
    """Read-only HDF5 file (the subset in the module docstring). Reads go
    through ``os.pread``, so threads may share one File."""

    def __init__(self, path):
        self.filename = str(path)
        self._fd = os.open(self.filename, os.O_RDONLY)
        try:
            self._size = os.fstat(self._fd).st_size
            self._root = self._superblock()
        except BaseException:
            os.close(self._fd)
            raise

    def read(self, addr: int, n: int) -> bytes:
        if addr == UNDEF or addr + n > self._size:
            raise FormatError(f"{self.filename}: read past the end "
                              f"({addr}+{n} of {self._size} bytes)")
        return os.pread(self._fd, n, addr)

    def _superblock(self) -> int:
        head = self.read(0, 24)
        if head[:8] != SIGNATURE:
            raise FormatError(f"{self.filename}: not an HDF5 file")
        version = head[8]
        if version not in (0, 1):
            raise FormatError(
                f"{self.filename}: superblock version {version} (a newer "
                "format, h5py's libver='latest') is not supported without "
                "h5py")
        if head[13] != 8 or head[14] != 8:
            raise FormatError(f"{self.filename}: offsets of {head[13]} and "
                              f"lengths of {head[14]} bytes")
        off = 24 + (4 if version == 1 else 0) + 32  # past four addresses
        entry = self.read(off, 40)
        return _u("Q", entry, 8)[0]  # the root group's object header

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- objects ----------------------------------------------------------

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of a version-1 object header."""
        prefix = self.read(addr, 16)
        if prefix[0] != 1:
            raise FormatError(f"{self.filename}: object header version "
                              f"{prefix[0]} at {addr}")
        count, _, size = _u("HII", prefix, 2)
        blocks = [(addr + 16, size)]
        out: List[Tuple[int, bytes]] = []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            p = 0
            while p + 8 <= length and len(out) < count:
                mtype, msize = _u("HH", data, p)
                body = data[p + 8:p + 8 + msize]
                if mtype == 0x10:  # continuation
                    blocks.append(_u("QQ", body))
                out.append((mtype, body))
                p += 8 + msize
        return out

    def _group_entries(self, msgs) -> Dict[str, int]:
        stab = [b for t, b in msgs if t == 0x11]
        if not stab:
            raise FormatError(f"{self.filename}: a group without a symbol "
                              "table (a newer format)")
        btree, heap = _u("QQ", stab[0])
        hh = self.read(heap, 32)
        if hh[:4] != b"HEAP":
            raise FormatError(f"{self.filename}: bad local heap at {heap}")
        dsize, _, daddr = _u("QQQ", hh, 8)
        names = self.read(daddr, dsize)
        out: Dict[str, int] = {}
        self._walk_group_tree(btree, names, out)
        return out

    def _walk_group_tree(self, addr, names, out) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise FormatError(f"{self.filename}: bad group B-tree at {addr}")
        level, used = head[5], _u("H", head, 6)[0]
        body = self.read(addr + 24, used * 16 + 8)
        for i in range(used):
            child = _u("Q", body, 8 + 16 * i)[0]
            if level > 0:
                self._walk_group_tree(child, names, out)
                continue
            node = self.read(child, 8)
            if node[:4] != b"SNOD":
                raise FormatError(f"{self.filename}: bad symbol node")
            n = _u("H", node, 6)[0]
            ents = self.read(child + 8, 40 * n)
            for j in range(n):
                name_off, header = _u("QQ", ents, 40 * j)
                end = names.index(b"\0", name_off)
                out[names[name_off:end].decode()] = header

    def _lookup(self, path: str) -> int:
        addr = self._root
        for part in [p for p in path.split("/") if p]:
            entries = self._group_entries(self.messages(addr))
            if part not in entries:
                raise KeyError(f"{path!r} not in {self.filename}")
            addr = entries[part]
        return addr

    def __getitem__(self, path: str):
        addr = self._lookup(path)
        msgs = self.messages(addr)
        if any(t == 0x11 for t, _ in msgs):
            return Group(self, path, msgs)
        return Dataset(self, path, msgs)


class Group:
    def __init__(self, f: File, path: str, msgs):
        self.file, self.name, self._msgs = f, path, msgs

    def keys(self):
        return list(self.file._group_entries(self._msgs))

    def __getitem__(self, path: str):
        return self.file[f"{self.name}/{path}"]


def _dtype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits, size = body[1], _u("I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed point
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:  # IEEE float
        return np.dtype(f"{order}f{size}")
    if cls == 8:  # enum (h5py's bool): its base type
        return _dtype(body[8:])
    raise FormatError(f"datatype class {cls} (version {version})")


def _shape(body: bytes) -> Tuple[int, ...]:
    version, rank = body[0], body[1]
    if version == 1:
        start = 8
    elif version == 2:
        if body[3] == 2:  # null dataspace
            return (0,)
        start = 4
    else:
        raise FormatError(f"dataspace version {version}")
    return tuple(_u(f"{rank}Q", body, start)) if rank else ()


def _filters(body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    version, n = body[0], body[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u("H", body, p)[0]
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = _u("H", body, p)[0]
            p += 2
        _, nvals = _u("HH", body, p)
        p += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        p += name_len
        vals = _u(f"{nvals}I", body, p)
        p += 4 * nvals
        if version == 1 and nvals % 2:
            p += 4
        out.append((fid, vals))
    return out


class Dataset:
    """One dataset: shape, dtype, and reads of the whole array or of a
    range of rows (``ds[lo:hi]``, ``ds[i]``, ``ds[()]``, ``np.asarray``)."""

    def __init__(self, f: File, path: str, msgs):
        self.file, self.name = f, path
        by_type = {t: b for t, b in msgs}
        for need in (0x01, 0x03, 0x08):
            if need not in by_type:
                raise FormatError(f"{path}: not a dataset")
        self.shape = _shape(by_type[0x01])
        self.dtype = _dtype(by_type[0x03])
        self.ndim = len(self.shape)
        self.size = int(np.prod(self.shape))
        self._filters = _filters(by_type[0x0B]) if 0x0B in by_type else []
        lay = by_type[0x08]
        if lay[0] != 3:
            raise FormatError(f"{path}: layout version {lay[0]}")
        self._class = lay[1]
        self.chunks = None
        if self._class == 0:  # compact: the data is in the message
            n = _u("H", lay, 2)[0]
            self._compact = lay[4:4 + n]
        elif self._class == 1:
            self._addr, self._nbytes = _u("QQ", lay, 2)
        elif self._class == 2:
            ndims = lay[2]
            self._btree = _u("Q", lay, 3)[0]
            self.chunks = tuple(_u(f"{ndims - 1}I", lay, 11))
        else:
            raise FormatError(f"{path}: layout class {self._class}")

    def __array__(self, dtype=None, copy=None):
        arr = self._rows(0, self.shape[0]) if self.ndim else self[()]
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, key):
        if (isinstance(key, tuple) and key == ()) or key is Ellipsis:
            if self.ndim == 0:
                return self._read_all().reshape(())[()]
            return self._rows(0, self.shape[0])
        if isinstance(key, (int, np.integer)):
            i = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(key)
            return self._rows(i, i + 1)[0]
        if isinstance(key, slice) and key.step in (None, 1):
            lo, hi, _ = key.indices(self.shape[0])
            return self._rows(lo, max(lo, hi))
        return np.asarray(self)[key]

    def _read_all(self) -> np.ndarray:
        if self._class == 0:
            raw = self._compact
        elif self._class == 1:
            if self._addr == UNDEF:
                return np.zeros(self.shape, self.dtype)
            raw = self.file.read(self._addr, self.size * self.dtype.itemsize)
        else:
            return self._rows(0, self.shape[0]) if self.ndim else (
                self._chunked(0, 1))
        return np.frombuffer(raw, self.dtype, self.size).reshape(self.shape)

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the first axis."""
        if self._class == 1 and self._addr != UNDEF:
            row = int(np.prod(self.shape[1:])) * self.dtype.itemsize
            raw = self.file.read(self._addr + lo * row, (hi - lo) * row)
            return np.frombuffer(raw, self.dtype).reshape(
                (hi - lo,) + self.shape[1:]).copy()
        if self._class == 2:
            return self._chunked(lo, hi)
        return self._read_all()[lo:hi].copy()

    def _chunk_index(self, addr: int, out: list) -> None:
        head = self.file.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise FormatError(f"{self.name}: bad chunk B-tree at {addr}")
        level, used = head[5], _u("H", head, 6)[0]
        ksize = 8 + 8 * (self.ndim + 1)
        body = self.file.read(addr + 24, used * (ksize + 8) + ksize)
        for i in range(used):
            k = i * (ksize + 8)
            child = _u("Q", body, k + ksize)[0]
            if level > 0:
                self._chunk_index(child, out)
            else:
                size, mask = _u("II", body, k)
                offset = _u(f"{self.ndim}Q", body, k + 8)
                out.append((offset, child, size, mask))

    def _decode(self, raw: bytes, mask: int) -> bytes:
        chunk_bytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, vals = self._filters[i]
            if fid == _FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _FILTER_SHUFFLE:
                n = self.dtype.itemsize
                raw = np.frombuffer(raw, np.uint8).reshape(n, -1).T.tobytes()
            elif fid == _FILTER_FLETCHER:
                raw = raw[:-4]
            elif fid == _FILTER_BLOSC:
                from bflow_tpu_torch.data import blosc_native

                out = (blosc_native.decompress(raw, chunk_bytes)
                       if blosc_native.available() else None)
                if out is None:
                    raise FormatError(f"{self.name}: a blosc chunk and no "
                                      "native blosc codec")
                raw = out
            else:
                raise FormatError(f"{self.name}: filter {fid}")
        return raw

    def _chunked(self, lo: int, hi: int) -> np.ndarray:
        shape = ((hi - lo,) + self.shape[1:]) if self.ndim else ()
        out = np.zeros(shape, self.dtype)
        index: list = []
        if self._btree != UNDEF:
            self._chunk_index(self._btree, index)
        for offset, addr, size, mask in index:
            if self.ndim and not (offset[0] < hi
                                  and offset[0] + self.chunks[0] > lo):
                continue
            block = np.frombuffer(self._decode(self.file.read(addr, size),
                                               mask), self.dtype,
                                  int(np.prod(self.chunks))
                                  ).reshape(self.chunks)
            if not self.ndim:
                return block.reshape(())
            src, dst = [], []
            for ax, (o, c, s) in enumerate(zip(offset, self.chunks,
                                               self.shape)):
                a, b = o, min(o + c, s)
                if ax == 0:
                    a, b = max(a, lo), min(b, hi)
                src.append(slice(a - o, b - o))
                dst.append(slice(a - (lo if ax == 0 else 0),
                                 b - (lo if ax == 0 else 0)))
            out[tuple(dst)] = block[tuple(src)]
        return out


# ---------------------------------------------------------------------------
# writing


def _datatype_message(dt: np.dtype) -> bytes:
    dt = np.dtype(dt).newbyteorder("<") if dt.byteorder == ">" else dt
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0x00
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    if dt.kind == "f" and size in (4, 8):
        exp, man, bias = (8, 23, 127) if size == 4 else (11, 52, 1023)
        return (bytes([0x11, 0x20, 8 * size - 1, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, man, exp, 0, man,
                              bias))
    raise TypeError(f"cannot write dtype {dt}")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    pad = (-len(body)) % 8
    return struct.pack("<HHB3x", mtype, len(body) + pad, flags) + body + (
        b"\0" * pad)


class _Writer:
    def __init__(self, fh):
        self.fh = fh
        self.pos = 0

    def put(self, data: bytes) -> int:
        """Append data at the next 8-byte boundary; returns its address."""
        pad = (-self.pos) % 8
        if pad:
            self.fh.write(b"\0" * pad)
            self.pos += pad
        addr = self.pos
        self.fh.write(data)
        self.pos += len(data)
        return addr

    def header(self, msgs: List[bytes]) -> int:
        body = b"".join(msgs)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                    len(body)) + body)

    def dataset(self, arr: np.ndarray, gzip_level: Optional[int]) -> int:
        arr = np.asarray(arr, order="C")  # 0-d stays 0-d
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        rank = arr.ndim
        space = struct.pack("<BBBx4x", 1, rank, 0) + struct.pack(
            f"<{rank}Q", *arr.shape)
        msgs = [_message(0x01, space),
                _message(0x03, _datatype_message(arr.dtype), 1)]
        if gzip_level is None or rank == 0 or arr.size == 0:
            addr = self.put(arr.tobytes()) if arr.size else UNDEF
            msgs += [_message(0x05, bytes([2, 2, 2, 0])),
                     _message(0x08, struct.pack("<BBQQ", 3, 1, addr,
                                                arr.nbytes))]
            return self.header(msgs)
        comp = zlib.compress(arr.tobytes(), gzip_level)
        chunk = self.put(comp)
        n = rank + 1
        dims = tuple(arr.shape) + (arr.dtype.itemsize,)
        ksize = 8 + 8 * n
        node = bytearray(24 + 2 * _CHUNK_NODE_K * 8
                         + (2 * _CHUNK_NODE_K + 1) * ksize)
        struct.pack_into("<4sBBHQQ", node, 0, b"TREE", 1, 0, 1, UNDEF, UNDEF)
        struct.pack_into(f"<II{n}QQ", node, 24, len(comp), 0, *([0] * n),
                         chunk)
        struct.pack_into(f"<II{n}Q", node, 24 + ksize + 8, 0, 0, *dims)
        btree = self.put(bytes(node))
        msgs += [_message(0x05, bytes([2, 3, 2, 0])),
                 _message(0x08, struct.pack(f"<BBBQ{n}I", 3, 2, n, btree,
                                            *dims)),
                 _message(0x0B, struct.pack("<BB6xHHHHIxxxx", 1, 1,
                                            _FILTER_DEFLATE, 0, 0, 1,
                                            gzip_level))]
        return self.header(msgs)

    def group(self, entries: Dict[str, Tuple[int, Optional[Tuple]]]
              ) -> Tuple[int, Tuple[int, int]]:
        """entries: name -> (object header, (B-tree, heap) of a group or
        None). Returns (object header, (B-tree, heap))."""
        names = sorted(entries, key=lambda s: s.encode())
        per_node = 2 * _GROUP_LEAF_K
        if len(names) > per_node * 2 * _GROUP_NODE_K:
            raise ValueError(f"a group of {len(names)} members")
        heap_data = bytearray(8)  # offset 0: the empty name
        offsets = {}
        for name in names:
            offsets[name] = len(heap_data)
            enc = name.encode() + b"\0"
            heap_data += enc + b"\0" * ((-len(enc)) % 8)
        data_addr = self.put(bytes(heap_data))
        heap = self.put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                                    1, data_addr))  # 1: no free block
        nodes, keys = [], [0]
        for i in range(0, max(len(names), 1), per_node):
            part = names[i:i + per_node]
            node = bytearray(8 + 40 * per_node)
            struct.pack_into("<4sBxH", node, 0, b"SNOD", 1, len(part))
            for j, name in enumerate(part):
                header, stab = entries[name]
                cache = 1 if stab else 0
                btree_heap = stab or (0, 0)
                struct.pack_into("<QQI4xQQ", node, 8 + 40 * j,
                                 offsets[name], header, cache, *btree_heap)
            nodes.append(self.put(bytes(node)))
            keys.append(offsets[part[-1]] if part else 0)
        tree = bytearray(24 + 2 * _GROUP_NODE_K * 8
                         + (2 * _GROUP_NODE_K + 1) * 8)
        struct.pack_into("<4sBBHQQ", tree, 0, b"TREE", 0, 0, len(nodes),
                         UNDEF, UNDEF)
        for i, child in enumerate(nodes):
            struct.pack_into("<QQ", tree, 24 + 16 * i, keys[i], child)
        struct.pack_into("<Q", tree, 24 + 16 * len(nodes), keys[-1])
        btree = self.put(bytes(tree))
        header = self.header([_message(0x11, struct.pack("<QQ", btree,
                                                         heap))])
        return header, (btree, heap)


def write_file(path, arrays: Mapping[str, np.ndarray],
               gzip_level: Optional[int] = None) -> None:
    """Write named arrays as an HDF5 file readable by h5py (see the module
    docstring); names with '/' make groups."""
    tree: dict = {}
    for name, arr in arrays.items():
        parts = [p for p in name.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name}: {p} is a dataset")
        node[parts[-1]] = np.asarray(arr)
    with open(path, "wb") as fh:
        w = _Writer(fh)
        w.put(b"\0" * 96)  # the superblock, written last

        def emit(node: dict):
            entries = {}
            for name, val in node.items():
                if isinstance(val, dict):
                    entries[name] = emit(val)
                else:
                    entries[name] = (w.dataset(val, gzip_level), None)
            return w.group(entries)

        root, (btree, heap) = emit(tree)
        eof = w.pos
        fh.seek(0)
        fh.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                 + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                 + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
