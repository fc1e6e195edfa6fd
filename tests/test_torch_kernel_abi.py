"""Each kernel wrapper's ctypes signature against the C signature it calls.

A ctypes argument list that disagrees with its ``extern "C"`` function
(one argument more or fewer, an int where a pointer goes) builds and
imports here and fails only on a card, if it fails at all: ctypes would
pass a pointer cut to 32 bits or shift every later argument.  This parses
every ``extern "C"`` function of ``avlmaps_torch/csrc/*.cu`` and holds it
against the ``argtypes`` its module's ``_lib()`` sets, with the library
replaced by a stand-in, so no compiler or card is needed.
"""

import ctypes
import importlib
import re

import pytest

from avlmaps_torch.kernels import build

_EXTERN = re.compile(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def c_signatures(name: str) -> dict:
    """``{function: [parameter types]}`` of ``csrc/<name>.cu``'s
    ``extern "C"`` functions, each type as ctypes spells it."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    sigs = {}
    for fn, params in _EXTERN.findall(src):
        types = []
        for p in params.split(","):
            ctype = re.match(r"\s*(.*?)\s*\w+\s*$", p).group(1)
            if "*" in ctype:
                types.append(ctypes.POINTER(ctypes.c_longlong)
                             if "long long" in ctype else ctypes.c_void_p)
            elif ctype == "float":
                types.append(ctypes.c_float)
            elif ctype == "int":
                types.append(ctypes.c_int)
            else:
                raise AssertionError(f"{fn}: unexpected parameter {p!r}")
        sigs[fn] = types
    return sigs


class _StandIn:
    """A loaded library's stand-in: every attribute is a function object
    that keeps the ``argtypes`` and ``restype`` set on it."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        return self.fns.setdefault(attr, type("Fn", (), {})())


def bound_signatures(name: str, monkeypatch) -> dict:
    lib = _StandIn()
    monkeypatch.setattr(build, "load", lambda n: lib)
    importlib.import_module(f"avlmaps_torch.ops.{name}")._lib()
    return {fn: (list(f.argtypes), f.restype) for fn, f in lib.fns.items()}


@pytest.mark.parametrize("name", build.sources())
def test_wrappers_bind_every_c_signature(name, monkeypatch):
    want = c_signatures(name)
    got = bound_signatures(name, monkeypatch)
    assert want, f"no extern \"C\" function found in {name}.cu"
    assert set(got) == set(want)
    for fn, types in want.items():
        args, restype = got[fn]
        assert len(args) == len(types), f"{fn}: {len(args)} argtypes for " \
            f"{len(types)} parameters"
        assert args == types, fn
        assert restype is ctypes.c_int, fn


def test_parser_reads_pointers_ints_and_floats():
    assert c_signatures("segment_scatter")["avl_segment_scatter_add"] == [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    mha = c_signatures("fused_vit")["avl_mha"]
    assert mha[4] == ctypes.POINTER(ctypes.c_longlong)
    assert mha[-2] is ctypes.c_float
    resample = c_signatures("clip_resample")["avl_clip_resample"]
    assert resample[12:18] == [ctypes.c_float] * 6
    assert c_signatures("sinkhorn")["avl_sinkhorn"] == [
        ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
