"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``avlmaps_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface,
``avlmaps_torch/_build/<name>-<hash>.so``, where ``<hash>`` covers the
source text and the compiler flags: an edited source gets a new library,
an unchanged one is reused.  Nothing here runs at import time, so the CPU
tests import every module without ``nvcc`` or a card.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them (a cold build costs as long as the slowest source, not the sum).
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
from typing import Dict, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Optional[Tuple[str, subprocess.Popen]]:
    """Start compiling ``name`` unless its library is current; returns
    ``(name, process)``, the process writing into a temporary file and its
    combined output to ``_build/<name>.log``."""
    if _target(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS]
    cutlass = Path("/usr/local/cutlass/include")
    if cutlass.is_dir():
        cmd += ["-I", str(cutlass)]
    cmd += ["-o", str(_tmp(name)), str(CSRC_DIR / f"{name}.cu")]
    with open(BUILD_DIR / f"{name}.log", "w") as log:
        return name, subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)


def _tmp(name: str) -> Path:
    return _target(name).with_suffix(f".{os.getpid()}.tmp.so")


def _finish(name: str, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    if rc != 0:
        log = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n{log}")
    os.replace(_tmp(name), _target(name))


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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(*started)
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
        return lib
