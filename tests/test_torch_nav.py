"""The port's navigation stack (avlmaps_torch/nav) against the JAX
package's: visibility-graph paths on seeded random obstacle maps on both
cores (the C++ core built by the port into ``avlmaps_torch/_build/``),
the escape corridor, the Navigator, the discrete controller's actions,
and the native library's ctypes signatures against
``native/visgraph.cpp``."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.nav import controller as jctl
from avlmaps_tpu.nav import navigator as jnavm
from avlmaps_tpu.nav import visgraph as jvg
from avlmaps_torch.config import load_config
from avlmaps_torch.nav import controller as tctl
from avlmaps_torch.nav import native as tnative
from avlmaps_torch.nav import navigator as tnavm
from avlmaps_torch.nav import visgraph as tvg
from tools.planner_eval import random_obstacle_map

REPO = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 2]


def _queries(m, rng, n=4):
    free = np.argwhere(m == 1)
    blocked = np.argwhere(m == 0)
    out = [(tuple(free[i]), tuple(free[j]))
           for i, j in rng.integers(0, len(free), (n, 2))]
    # a start and a goal inside obstacles (the recovery paths)
    out.append((tuple(blocked[len(blocked) // 2]), tuple(free[0])))
    out.append((tuple(free[-1]), tuple(blocked[len(blocked) // 3])))
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", SEEDS)
def test_paths_match_jax(seed, native):
    rng = np.random.default_rng(seed)
    m = random_obstacle_map(rng, size=96, hollow=seed == 2)
    tg = tvg.VisGraph(m, use_native=native)
    jg = jvg.VisGraph(m, use_native=native)
    assert tg.core == ("native" if native else "python")
    assert (jg._native is not None) == native
    assert len(tg.polys) == len(jg.polys)
    for a, b in zip(tg.polys, jg.polys):
        np.testing.assert_array_equal(a, b)
    assert tg.n_edges > 0
    if not native:
        assert tg._adj == jg._adj
    for start, goal in _queries(m, rng):
        assert tvg.plan_to_pos_v2(start, goal, m, graph=tg) == \
            jvg.plan_to_pos_v2(start, goal, m, graph=jg)
        assert tg.shortest_path(start, goal) == jg.shortest_path(start, goal)


def test_both_cores_give_the_same_paths():
    """The two cores' graphs may differ in a few edges that no shortest
    path uses (the JAX package's own native test holds lengths)."""
    m = random_obstacle_map(np.random.default_rng(5), size=96)
    native, python = tvg.VisGraph(m), tvg.VisGraph(m, use_native=False)
    assert native.core == "native" and python.core == "python"
    assert native.n_edges > 0 and python.n_edges > 0
    for start, goal in _queries(m, np.random.default_rng(6)):
        pn = np.asarray(native.shortest_path(start, goal))
        pp = np.asarray(python.shortest_path(start, goal))
        ln = np.hypot(*np.diff(pn, axis=0).T).sum()
        lp = np.hypot(*np.diff(pp, axis=0).T).sum()
        np.testing.assert_allclose(ln, lp, rtol=1e-9)


def test_native_library_lives_in_the_build_dir():
    assert tnative.load_native() is not None
    path = tnative.library_path()
    assert path.exists() and path.parent == REPO / "avlmaps_torch" / "_build"
    assert re.fullmatch(r"visgraph-[0-9a-f]{16}\.so", path.name)


@pytest.mark.parametrize("case", ["pocket", "connected", "main_region",
                                  "tie"])
def test_carve_escape_corridor_matches_jax(case):
    m = np.ones((100, 100), np.uint8)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 0
    m[40:70, 40:70] = 0
    m[44:66, 44:66] = 1
    point = (55, 55)
    if case == "connected":
        m[40:70, 55] = 1
    elif case == "main_region":
        point = (10, 10)
    elif case == "tie":
        m = np.zeros((9, 9), np.uint8)
        m[1:3, 1:3] = 1
        m[6:8, 6:8] = 1
        point = (1, 1)
    np.testing.assert_array_equal(tvg.carve_escape_corridor(m, point),
                                  jvg.carve_escape_corridor(m, point))
    tg = tvg.build_visgraph_with_obs_map(m, use_internal_contour=True,
                                         internal_point=point)
    jg = jvg.build_visgraph_with_obs_map(m, use_internal_contour=True,
                                         internal_point=point)
    np.testing.assert_array_equal(tg.obs_map, jg.obs_map)


def _configs():
    cfgs = []
    for cfg in (load_config(), jax_load_config()):
        cfg.controller_config.gs = 100
        cfg.controller_config.cs = 0.05
        cfgs.append(cfg)
    return cfgs


def test_navigator_and_controller_match_jax():
    tcfg, jcfg = _configs()
    m = random_obstacle_map(np.random.default_rng(3), size=80)
    tnav, jnav = tnavm.Navigator(), jnavm.Navigator()
    tnav.build_visgraph(m, 10, 7)
    jnav.build_visgraph(m, 10, 7)
    tc = tctl.DiscreteNavController(tcfg.controller_config)
    jc = jctl.DiscreteNavController(jcfg.controller_config)
    rng = np.random.default_rng(4)
    for start, goal in _queries(m, rng):
        s_full = (start[0] + 10, start[1] + 7)
        g_full = (goal[0] + 10, goal[1] + 7)
        paths = tnav.plan_to(s_full, g_full)
        assert paths == jnav.plan_to(s_full, g_full)
        pose = (*s_full, float(rng.integers(-180, 180)))
        got = tc.convert_paths_to_actions(pose, paths[1:])
        want = jc.convert_paths_to_actions(pose, paths[1:])
        assert got[0] == want[0] and len(got[0]) > 0
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))
        for goal_rc in paths:
            assert tc.convert_goal_to_actions(pose, goal_rc) == \
                jc.convert_goal_to_actions(pose, goal_rc)


def test_navigator_rebuilds_on_a_sealed_start():
    m = np.ones((100, 100), np.uint8)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 0
    m[40:70, 40:70] = 0
    m[44:66, 44:66] = 1
    m[55, 55] = 0  # the start stands on an obstacle cell inside the pocket
    tnav, jnav = tnavm.Navigator(), jnavm.Navigator()
    tnav.build_visgraph(m, 0, 0)
    jnav.build_visgraph(m, 0, 0)
    assert tnav.plan_to((55, 55), (10, 10)) == jnav.plan_to((55, 55),
                                                            (10, 10))


_EXTERN = re.compile(r"^(void\*|void|int|long)\s+(vg_\w+)\(([^)]*)\)",
                     re.MULTILINE)
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long": ctypes.c_long, "double": ctypes.c_double,
           "const uint8_t*": ctypes.POINTER(ctypes.c_uint8),
           "const double*": ctypes.POINTER(ctypes.c_double),
           "double*": ctypes.POINTER(ctypes.c_double),
           "const int*": ctypes.POINTER(ctypes.c_int), "void": None}


def native_signatures() -> dict:
    """``{function: (restype, [argtypes])}`` of native/visgraph.cpp's
    ``extern "C"`` block, each type as ctypes spells it."""
    src = (REPO / "native" / "visgraph.cpp").read_text()
    block = src[src.index('extern "C" {'):]
    sigs = {}
    for ret, fn, params in _EXTERN.findall(block):
        types = []
        for p in params.replace("\n", " ").split(","):
            ctype = re.match(r"\s*(.*?)\s*\w+\s*$", p).group(1)
            ctype = re.sub(r"\s+\*", "*", ctype)
            types.append(_CTYPES[ctype])
        sigs[fn] = (_CTYPES[ret], types)
    return sigs


def test_native_argtypes_match_the_c_signatures():
    class Fn:
        pass

    class StandIn:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, attr):
            if attr.startswith("_"):
                raise AttributeError(attr)
            return self.fns.setdefault(attr, Fn())

    lib = StandIn()
    tnative._bind(lib)
    want = native_signatures()
    assert set(want) == {"vg_build", "vg_n_edges", "vg_plan", "vg_free"}
    assert set(lib.fns) == set(want)
    for fn, (restype, argtypes) in want.items():
        assert lib.fns[fn].restype == restype, fn
        assert list(lib.fns[fn].argtypes) == argtypes, fn


def test_python_core_runs_when_the_native_build_fails(monkeypatch):
    """VisGraph(use_native=True) falls back to the pure-Python core when
    the library cannot be built or loaded, as the JAX package does, and
    says so through ``core``."""
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    m = random_obstacle_map(np.random.default_rng(7), size=80)
    tg = tvg.VisGraph(m, use_native=True)
    jg = jvg.VisGraph(m, use_native=False)
    assert tg.core == "python"
    for start, goal in _queries(m, np.random.default_rng(8)):
        assert tg.shortest_path(start, goal) == jg.shortest_path(start, goal)
