"""A small HDF5 reader and writer for the voxel map's files.

``map/voxel_map.py`` saves and loads maps through this module on every
host.  It writes and reads the subset of HDF5 the map needs: one root group holding contiguous, uncompressed datasets of
little-endian integers and floats (scalars included).  Files written here
are plain HDF5 (superblock version 0, version-1 object headers, a
symbol-table root group -- the layout h5py's default ``libver="earliest"``
produces), so h5py and the JAX package read them; files h5py writes with
that default are read back here.  Chunked, compressed or filtered
datasets, and nested groups, raise ``ValueError``.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4  # a symbol-table node holds up to 2 * LEAF_K entries
INTERNAL_K = 16  # a group B-tree node holds up to 2 * INTERNAL_K children
HEAP_FREE_NULL = 1  # the library's "no free block" heap offset

MSG_NIL, MSG_DATASPACE, MSG_DATATYPE = 0x0000, 0x0001, 0x0003
MSG_FILL, MSG_LAYOUT, MSG_FILTERS = 0x0005, 0x0008, 0x000B
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x0010, 0x0011


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


# ------------------------------------------------------------------ write --

def _datatype(dt: np.dtype) -> bytes:
    if dt.kind in "iu":
        signed = 0x08 if dt.kind == "i" else 0x00
        return (struct.pack("<BBBBI", 0x10, signed, 0, 0, dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        sign, eloc, esize, msize, bias = ((31, 23, 8, 23, 127)
                                          if dt.itemsize == 4
                                          else (63, 52, 11, 52, 1023))
        return (struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, 0,
                              msize, bias))
    raise ValueError(f"hdf5: unsupported dtype {dt}")


def _object_header(messages) -> bytes:
    body = b""
    for mtype, flags, data in messages:
        data = _pad8(data)
        body += struct.pack("<HHB3x", mtype, len(data), flags) + data
    return (struct.pack("<BBHII", 1, 0, len(messages), 1, len(body))
            + b"\0" * 4 + body)


def write(path: Union[str, Path], datasets: Mapping[str, np.ndarray]) -> None:
    """Write ``datasets`` (name -> array) as one root group."""
    names = sorted(datasets)
    # the sorted names fill symbol-table nodes of 2 * LEAF_K entries, all
    # children of the one group B-tree node (as h5py lays out a group)
    leaves = [names[i:i + 2 * LEAF_K]
              for i in range(0, len(names), 2 * LEAF_K)] or [[]]
    if len(leaves) > 2 * INTERNAL_K:
        raise ValueError(f"hdf5: at most {4 * LEAF_K * INTERNAL_K} "
                         "datasets per file")
    # np.asarray keeps 0-d scalars 0-d (ascontiguousarray would not)
    arrays = {n: np.asarray(datasets[n]) for n in names}
    for n, a in arrays.items():
        arrays[n] = a.astype(a.dtype.newbyteorder("<"), order="C",
                             copy=False)

    heap_data = b"\0" * 8  # offset 0: the empty name
    name_off = {}
    for n in names:
        name_off[n] = len(heap_data)
        heap_data += _pad8(n.encode() + b"\0")

    off_root = 96  # the superblock's length
    root_hdr_len = len(_object_header([(MSG_SYMBOL_TABLE, 0, b"\0" * 16),
                                       (MSG_NIL, 0, b"\0" * 8)]))
    off_heap = off_root + root_hdr_len
    off_heap_data = off_heap + 32
    off_btree = off_heap_data + len(heap_data)
    btree_len = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
    off_snod = off_btree + btree_len
    snod_len = 8 + 2 * LEAF_K * 40
    cursor = off_snod + snod_len * len(leaves)

    headers, data_off = {}, {}
    for n in names:
        a = arrays[n]
        hdr_len = len(_object_header(_dataset_messages(a, 0)))
        headers[n] = cursor
        cursor += hdr_len
        data_off[n] = cursor if a.nbytes else UNDEF
        cursor += a.nbytes + (-a.nbytes % 8)
    eof = cursor

    superblock = (SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
                  + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                  + struct.pack("<QQI4xQQ", 0, off_root, 1, off_btree,
                                off_heap))
    root = _object_header([(MSG_SYMBOL_TABLE, 0,
                            struct.pack("<QQ", off_btree, off_heap)),
                           (MSG_NIL, 0, b"\0" * 8)])
    heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                 HEAP_FREE_NULL, off_heap_data)
    # keys: the empty name, then each child's last (largest) name
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(names) and len(leaves),
                                  UNDEF, UNDEF) + struct.pack("<Q", 0)
    if names:
        for k, leaf in enumerate(leaves):
            btree += struct.pack("<QQ", off_snod + k * snod_len,
                                 name_off[leaf[-1]])
    btree += b"\0" * (btree_len - len(btree))
    snods = b""
    for leaf in leaves:
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(leaf))
        for n in leaf:
            snod += struct.pack("<QQI4x16x", name_off[n], headers[n], 0)
        snods += snod + b"\0" * (snod_len - len(snod))

    with open(path, "wb") as f:
        f.write(superblock)
        assert f.tell() == off_root
        f.write(root + heap + heap_data + btree + snods)
        for n in names:
            a = arrays[n]
            assert f.tell() == headers[n]
            f.write(_object_header(_dataset_messages(a, data_off[n])))
            f.write(a.tobytes())
            f.write(b"\0" * (-a.nbytes % 8))
        assert f.tell() == eof


def _dataset_messages(a: np.ndarray, addr: int):
    space = struct.pack("<BBBB4x", 1, a.ndim, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in a.shape)
    return [(MSG_DATASPACE, 0, space),
            (MSG_DATATYPE, 1, _datatype(a.dtype)),
            (MSG_FILL, 1, struct.pack("<BBBB", 2, 1, 2, 0)),
            (MSG_LAYOUT, 0, struct.pack("<BBQQ", 3, 1, addr, a.nbytes))]


# ------------------------------------------------------------------- read --

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        if bytes(buf[:8]) != SIGNATURE:
            raise ValueError("hdf5: no HDF5 signature at offset 0")
        version = buf[8]
        if version not in (0, 1):
            raise ValueError(f"hdf5: superblock version {version} "
                             "(only the h5py libver='earliest' layout)")
        if buf[13] != 8 or buf[14] != 8:
            raise ValueError("hdf5: only 8-byte offsets and lengths")
        entry = 24 + (4 if version == 1 else 0) + 32
        self.root_header = self.u64(entry + 8)

    def u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self.buf, off)[0]

    def messages(self, addr: int):
        """(type, data offset, size) of every message of a v1 header."""
        if self.buf[addr] != 1:
            raise ValueError("hdf5: only version-1 object headers")
        n_msgs, _, size = struct.unpack_from("<HII", self.buf, addr + 2)
        chunks = [(addr + 16, size)]
        out = []
        while chunks and len(out) < n_msgs:
            start, length = chunks.pop(0)
            pos = start
            while pos + 8 <= start + length and len(out) < n_msgs:
                mtype, msize = struct.unpack_from("<HH", self.buf, pos)
                if mtype == MSG_CONTINUATION:
                    chunks.append((self.u64(pos + 8), self.u64(pos + 16)))
                out.append((mtype, pos + 8, msize))
                pos += 8 + msize
        return out

    def group_entries(self):
        """name -> object header address for every link of the root."""
        msgs = {t: off for t, off, _ in self.messages(self.root_header)}
        if MSG_SYMBOL_TABLE not in msgs:
            raise ValueError("hdf5: root group is not a symbol-table group")
        btree = self.u64(msgs[MSG_SYMBOL_TABLE])
        heap = self.u64(msgs[MSG_SYMBOL_TABLE] + 8)
        if bytes(self.buf[heap:heap + 4]) != b"HEAP":
            raise ValueError("hdf5: bad local heap")
        heap_data = self.u64(heap + 24)
        out = {}
        for name_off, header in self._walk(btree):
            end = self.buf.find(b"\0", heap_data + name_off)
            out[bytes(self.buf[heap_data + name_off:end]).decode()] = header
        return out

    def _walk(self, node: int):
        if bytes(self.buf[node:node + 4]) != b"TREE":
            raise ValueError("hdf5: bad group B-tree node")
        level = self.buf[node + 5]
        used = struct.unpack_from("<H", self.buf, node + 6)[0]
        for i in range(used):
            child = self.u64(node + 24 + 8 + 16 * i)
            if level > 0:
                yield from self._walk(child)
                continue
            if bytes(self.buf[child:child + 4]) != b"SNOD":
                raise ValueError("hdf5: bad symbol-table node")
            n = struct.unpack_from("<H", self.buf, child + 6)[0]
            for j in range(n):
                e = child + 8 + 40 * j
                yield self.u64(e), self.u64(e + 8)

    def dataset(self, header: int) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, off, _ in self.messages(header):
            b = self.buf
            if mtype == MSG_DATASPACE:
                version, rank = b[off], b[off + 1]
                dims = off + (8 if version == 1 else 4)
                if version == 2 and b[off + 3] == 2:
                    raise ValueError("hdf5: null dataspace")
                shape = tuple(self.u64(dims + 8 * i) for i in range(rank))
            elif mtype == MSG_DATATYPE:
                cls, bits, size = b[off] & 0x0F, b[off + 1], \
                    struct.unpack_from("<I", b, off + 4)[0]
                order = ">" if bits & 1 else "<"
                if cls == 0:
                    kind = "i" if bits & 0x08 else "u"
                elif cls == 1:
                    kind = "f"
                else:
                    raise ValueError(f"hdf5: datatype class {cls}")
                dtype = np.dtype(f"{order}{kind}{size}")
            elif mtype == MSG_LAYOUT:
                if b[off] != 3:
                    raise ValueError(f"hdf5: layout version {b[off]}")
                if b[off + 1] == 1:  # contiguous
                    layout = ("contiguous", self.u64(off + 2))
                elif b[off + 1] == 0:  # compact
                    n = struct.unpack_from("<H", b, off + 2)[0]
                    layout = ("compact", off + 4, n)
                else:
                    raise ValueError("hdf5: chunked datasets unsupported")
            elif mtype == MSG_FILTERS:
                raise ValueError("hdf5: filtered datasets unsupported")
        if shape is None or dtype is None or layout is None:
            raise ValueError("hdf5: object is not a dataset")
        count = int(np.prod(shape, dtype=np.int64))
        if layout[0] == "compact":
            start = layout[1]
        elif layout[1] == UNDEF or count == 0:
            return np.zeros(shape, dtype.newbyteorder("="))
        else:
            start = layout[1]
        arr = np.frombuffer(self.buf, dtype, count, start).reshape(shape)
        return arr.astype(dtype.newbyteorder("="))


def read(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """All datasets of the root group, name -> array (copies)."""
    with open(path, "rb") as f:
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            r = _Reader(buf)
            return {n: r.dataset(h) for n, h in r.group_entries().items()}
