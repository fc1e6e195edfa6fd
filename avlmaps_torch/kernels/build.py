"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``avlmaps_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface,
``avlmaps_torch/_build/<name>-<hash>.so``, where ``<hash>`` covers the
source text and the compiler flags: an edited source gets a new library,
an unchanged one is reused.  Nothing here runs at import time, so the CPU
tests import every module without ``nvcc`` or a card.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them (a cold build costs as long as the slowest source, not the sum).
:func:`start_compile` / :func:`finish_compile` name and install any
library this way; ``nav/native.py`` builds the planner's C++ core with
them and ``g++``.

This module is also the one seam between the ``ops/`` wrappers and the
libraries: :func:`load` sets ``argtypes`` and ``restype`` on every
``extern "C"`` function from the source's own declaration
(:func:`signatures`), so a wrapper calls ``build.load(name).avl_...(...)``
and checks the returned ``cudaError_t`` with :func:`check`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_EXTERN = re.compile(r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float}


def sources() -> List[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_target(src: Path, flags: Sequence[str]) -> Path:
    """``_build/<stem>-<hash>.so`` for ``src`` compiled with ``flags``; the
    hash covers the source text and the flags."""
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _staging(target: Path) -> Path:
    return target.with_suffix(f".{os.getpid()}.tmp.so")


def start_compile(compiler: str, src: Path, flags: Sequence[str],
                  extra: Sequence[str] = ()) -> subprocess.Popen:
    """Start ``compiler flags extra -o <tmp> src``: the library is written
    into a file private to this process, its combined output to
    ``_build/<stem>.log``.  :func:`finish_compile` moves it into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [compiler, *flags, *extra, "-o",
           str(_staging(library_target(src, flags))), str(src)]
    with open(BUILD_DIR / f"{src.stem}.log", "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def finish_compile(proc: subprocess.Popen, src: Path, flags: Sequence[str],
                   timeout: Optional[float] = None) -> Path:
    """Wait for :func:`start_compile`'s process and rename its library onto
    :func:`library_target`, so processes building at once never load a
    half-written file; raises ``RuntimeError`` with the log on failure."""
    target = library_target(src, flags)
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        _staging(target).unlink(missing_ok=True)
        log = (BUILD_DIR / f"{src.stem}.log").read_text()
        raise RuntimeError(f"{proc.args[0]} failed for {src.name} "
                           f"(exit {rc}):\n{log}")
    os.replace(_staging(target), target)
    return target


def _start(name: str) -> Optional[Tuple[str, subprocess.Popen]]:
    """Start compiling ``csrc/<name>.cu`` unless its library is current."""
    src = CSRC_DIR / f"{name}.cu"
    if library_target(src, NVCC_FLAGS).exists():
        return None
    cutlass = Path("/usr/local/cutlass/include")
    extra = ["-I", str(cutlass)] if cutlass.is_dir() else []
    return name, start_compile(_nvcc(), src, NVCC_FLAGS, extra)


def _finish(name: str, proc: subprocess.Popen) -> None:
    finish_compile(proc, CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build_all() -> Dict[str, str]:
    """Compile every stale source in parallel; returns name -> nvcc log."""
    with _lock:
        started = [p for p in (_start(n) for n in sources()) if p is not None]
        try:
            for name, proc in started:
                _finish(name, proc)
        finally:
            for _, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    logs = {}
    for n in sources():
        f = BUILD_DIR / f"{n}.log"
        logs[n] = f.read_text() if f.exists() else ""
    return logs


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill-store bytes of every function in an nvcc log
    written with ``-Xptxas -v``, by mangled name (template arguments stay
    readable in it, e.g. ``wgmma_gemm_kernelILi0ELi0ELi256ELb0EE``)."""
    funcs: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            funcs[cur]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[cur]["registers"] = int(m.group(1))
    return funcs


def signatures(src: Path) -> Dict[str, list]:
    """``{function: argtypes}`` of every ``extern "C"`` function of
    ``src``: a pointer is ``c_void_p`` (``long long*`` is
    ``POINTER(c_longlong)``), ``int`` and ``float`` are themselves.  Any
    other parameter type, or a return type other than ``int`` (a
    ``cudaError_t``), raises ``TypeError`` naming the function."""
    sigs = {}
    for ret, fn, params in _EXTERN.findall(src.read_text()):
        if ret != "int":
            raise TypeError(f"{src.name}: {fn} returns {ret}, not int")
        types = []
        for p in params.split(","):
            ctype = re.match(r"\s*(.*?)\s*\w+\s*$", p).group(1)
            if "*" in ctype:
                types.append(ctypes.POINTER(ctypes.c_longlong)
                             if "long long" in ctype else ctypes.c_void_p)
            elif ctype in _SCALARS:
                types.append(_SCALARS[ctype])
            else:
                raise TypeError(f"{src.name}: {fn} has a parameter "
                                f"{p.strip()!r} of no ctypes type here")
        sigs[fn] = types
    return sigs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed,
    with :func:`signatures` set on its functions (once, at first load)."""
    lib = _libs.get(name)  # a bound library: no lock on the launch path
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        sigs = signatures(src)
        started = _start(name)
        if started is not None:
            _finish(*started)
        lib = ctypes.CDLL(str(library_target(src, NVCC_FLAGS)))
        for fn, types in sigs.items():
            f = getattr(lib, fn)
            f.argtypes = types
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise ``RuntimeError`` unless a launch returned ``cudaSuccess``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def require(cond: bool, msg: str, *args) -> None:
    """Raise ``ValueError(msg.format(*args))`` unless ``cond``: the message
    is formatted only on failure, since every launch checks its inputs."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)
