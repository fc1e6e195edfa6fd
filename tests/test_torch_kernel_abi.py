"""Each kernel library's ctypes signatures against its C declarations.

A ctypes argument list that disagrees with its ``extern "C"`` function
(one argument more or fewer, an int where a pointer goes) builds and
imports here and fails only on a card, if it fails at all: ctypes would
pass a pointer cut to 32 bits or shift every later argument.  So
``kernels/build.py`` reads every argument list from the source's own
declarations (``build.signatures``) and sets it when it loads the
library; the wrappers in ``ops/`` bind nothing.  These tests hold the
parser and ``build.load``'s binding with the library replaced by a
stand-in, and every wrapper's call to a C function to its parameter
count, so no compiler or card is needed.
"""

import ast
import ctypes

import pytest

from avlmaps_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64P = ctypes.POINTER(ctypes.c_longlong)
OPS = sorted((build.PKG_DIR / "ops").glob("*.py"))


class _StandIn:
    """A loaded library's stand-in: every attribute is a function object
    that keeps the ``argtypes`` and ``restype`` set on it."""

    def __init__(self, path):
        self.path, self.fns = path, {}

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        return self.fns.setdefault(attr, type("Fn", (), {})())


@pytest.fixture
def opened(monkeypatch):
    """``build.load`` with nothing compiled and nothing loaded yet: each
    library it opens is a stand-in, recorded in the returned list."""
    libs = []

    def cdll(path):
        libs.append(_StandIn(path))
        return libs[-1]

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_start", lambda name: None)
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    return libs


def _calls(fn: str):
    """(module, positional arguments, starred?) of every call of the C
    function ``fn`` in ``avlmaps_torch/ops/``."""
    for path in OPS:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == fn):
                starred = any(isinstance(a, ast.Starred) for a in node.args)
                yield path.name, len(node.args), starred


@pytest.mark.parametrize("name", build.sources())
def test_wrappers_bind_every_c_signature(name, opened):
    want = build.signatures(build.CSRC_DIR / f"{name}.cu")
    assert want, f"no extern \"C\" function found in {name}.cu"
    lib = build.load(name)
    assert build.load(name) is lib and len(opened) == 1, "bound twice"
    assert set(lib.fns) == set(want)
    for fn, types in want.items():
        f = lib.fns[fn]
        assert list(f.argtypes) == types, fn
        assert f.restype is ctypes.c_int, fn
        calls = list(_calls(fn))
        assert calls, f"no wrapper in ops/ calls {fn}"
        for module, n, starred in calls:
            assert n <= len(types) if starred else n == len(types), \
                f"{module} calls {fn} with {n} arguments for {len(types)} " \
                "parameters"


def test_parser_reads_pointers_ints_and_floats():
    def sigs(name):
        return build.signatures(build.CSRC_DIR / f"{name}.cu")

    assert sigs("segment_scatter")["avl_segment_scatter_add"] == [
        _P] * 3 + [_I] * 3 + [_P]
    mha = sigs("fused_vit")["avl_mha"]
    assert mha[4] == _I64P
    assert mha[-2] is _F
    assert sigs("clip_resample")["avl_clip_resample"][12:18] == [_F] * 6
    assert sigs("sinkhorn")["avl_sinkhorn"] == [_P] * 10 + [_I] * 6 + [_P]
    assert sigs("superglue_attention")["avl_superglue_attention"] == [
        _P] * 5 + [_I] * 4 + [_F, _P]


def _plant(tmp_path, monkeypatch, decl: str) -> None:
    (tmp_path / "planted.cu").write_text(
        "#include <cuda_runtime.h>\n\n"
        f'extern "C" {decl} {{\n  return 0;\n}}\n')
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)


@pytest.mark.parametrize("param, ctype", [
    ("long long* strides", _I64P), ("const long long* strides", _I64P),
    ("float eps", _F), ("int n", _I), ("const void* x", _P),
    ("float* out", _P)], ids=["long_long_ptr", "const_long_long_ptr",
                              "float", "int", "void_ptr", "float_ptr"])
def test_load_binds_a_planted_parameter(tmp_path, monkeypatch, opened,
                                        param, ctype):
    _plant(tmp_path, monkeypatch,
           f"int avl_planted(void* a, {param}, void* stream)")
    f = build.load("planted").fns["avl_planted"]
    assert list(f.argtypes) == [_P, ctype, _P]
    assert f.restype is ctypes.c_int


@pytest.mark.parametrize("decl, match", [
    ("int avl_planted(void* a, double scale, void* stream)",
     "avl_planted has a parameter 'double scale'"),
    ("void avl_planted(void* a, int n)", "avl_planted returns void")],
    ids=["double_parameter", "void_return"])
def test_load_refuses_a_planted_signature(tmp_path, monkeypatch, opened,
                                          decl, match):
    _plant(tmp_path, monkeypatch, decl)
    with pytest.raises(TypeError, match=match):
        build.load("planted")
    assert not opened and build._libs == {}
