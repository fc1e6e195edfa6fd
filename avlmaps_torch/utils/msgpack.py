"""A reader of flax's msgpack checkpoint format, on the standard library
and numpy.

``tools/port_checkpoints.py`` writes the JAX package's weights as
``flax.serialization.to_bytes`` trees; the port reads them without flax or
the ``msgpack`` package.  :func:`restore` is ``flax.serialization.
msgpack_restore``: maps, arrays, str, bin, nil, bool, every int and float
width, and flax's extension types

- 1, an ndarray: msgpack ``(shape, dtype name, bytes)``; ``"bfloat16"``
  becomes a ``torch.bfloat16`` tensor (numpy has no bf16 of its own),
  every other dtype a numpy array;
- 2, a complex: msgpack ``(real, imag)``;
- 3, a numpy scalar: an ndarray of shape ().

Arrays above flax's chunk size arrive as ``__msgpack_chunked_array__``
dicts and are reassembled.  Anything else raises with its type code.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Union

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: type byte -> struct format (big-endian)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# variable-length heads: type byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
# fixext 1, 2, 4, 8, 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.container("map", t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.container("array", t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return self.text(t & 0x1f)
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[t]))
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n)
            if kind == "ext":
                code = self.unpack(">b")
                return _ext(code, self.take(n))
            return self.container(kind, n)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def container(self, kind: str, n: int):
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data, raw: bool = False) -> Any:
    """One msgpack object from ``data`` with flax's extension types
    (``raw=True`` leaves str as bytes, as flax reads an ndarray's head)."""
    r = _Reader(data, raw=raw)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return out


def _ndarray(data) -> Union[np.ndarray, torch.Tensor]:
    shape, name, buf = unpackb(data, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _ext(code: int, data) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(d):
    """flax's ``_unchunk_array_leaves_in_place``: dicts only, not lists."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_in_place(v)
    return d


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts, lists,
    scalars and array leaves of a flax msgpack file's bytes."""
    return _unchunk_in_place(unpackb(data))


def load(path: Union[str, Path]) -> Any:
    """:func:`restore` of a file."""
    return restore(Path(path).read_bytes())

