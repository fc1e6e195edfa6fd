"""ctypes binding for the native visibility-graph core (native/visgraph.cpp).

Counterpart of ``avlmaps_tpu/nav/native.py``.  The unchanged C++ source is
compiled with ``g++`` on first use into
``avlmaps_torch/_build/visgraph-<hash>.so``, where ``<hash>`` covers the
source text and the flags; ``kernels/build.py`` names, builds and installs
it as it does the CUDA libraries, so nothing is written next to the source.
When the toolchain or the build is unavailable :func:`load_native` returns
None and ``nav/visgraph.py`` plans with its pure-Python core
(``VisGraph.core`` says which ran).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from avlmaps_torch.kernels import build

SRC = Path(__file__).resolve().parents[2] / "native" / "visgraph.cpp"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    return build.library_target(SRC, FLAGS)


def _compile() -> bool:
    try:
        build.finish_compile(build.start_compile("g++", SRC, FLAGS), SRC,
                             FLAGS, timeout=120)
        return True
    except (OSError, RuntimeError):  # no g++, or it failed
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The ``extern "C"`` signatures of native/visgraph.cpp."""
    lib.vg_build.restype = ctypes.c_void_p
    lib.vg_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.vg_plan.restype = ctypes.c_int
    lib.vg_plan.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.vg_n_edges.restype = ctypes.c_long
    lib.vg_n_edges.argtypes = [ctypes.c_void_p]
    lib.vg_free.restype = None
    lib.vg_free.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The compiled library, building it on first call; None on failure."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not SRC.exists():
            _build_failed = True
            return None
        target = library_path()
        if not target.exists() and not _compile():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            # a foreign binary (another arch or ABI) under this name
            if not _compile():
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(str(target))
            except OSError:
                _build_failed = True
                return None
        _lib = _bind(lib)
        return _lib


class NativeVisGraph:
    """Handle-owning wrapper around the C++ graph."""

    def __init__(self, obstacles: np.ndarray, nodes: np.ndarray,
                 poly_offsets: np.ndarray):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native visgraph unavailable")
        self._lib = lib
        self._obstacles = np.ascontiguousarray(obstacles, np.uint8)
        self._nodes = np.ascontiguousarray(nodes, np.float64)
        self._offsets = np.ascontiguousarray(poly_offsets, np.int32)
        h, w = self._obstacles.shape
        self._handle = lib.vg_build(
            self._obstacles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w,
            self._nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(self._nodes),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(self._offsets) - 1)

    @property
    def n_edges(self) -> int:
        return int(self._lib.vg_n_edges(self._handle))

    def plan(self, start, goal,
             max_len: int = 4096) -> Optional[List[List[float]]]:
        out = np.empty((max_len, 2), np.float64)
        n = self._lib.vg_plan(
            self._handle, float(start[0]), float(start[1]), float(goal[0]),
            float(goal[1]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_len)
        if n < 0:
            return None
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vg_free(self._handle)
            self._handle = None
