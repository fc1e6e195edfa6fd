"""The port's tools (avlmaps_torch/tools) against the JAX package's
(tools/planner_eval.py, tools/loc_eval.py, tools/pack_scene.py) on the
same seeded inputs, and every new command-line module of the port
importing and answering ``--help`` with JAX and the JAX package blocked.

Tolerances: the planner is host numpy and OpenCV in both packages, so
its queries, feasibility and ratios are equal (wall-clock times are left
out); the ORB localisation rows are equal; the SuperPoint row differs
only by the f32 forward's summation order (1.7e-9 m on the median and
the mean on this CPU), held within 1e-3 m; ``pack_scene`` writes the
same bytes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from avlmaps_tpu.models.superpoint import \
    SuperPointConfig as JaxSPConfig  # noqa: E402
from avlmaps_tpu.models.superpoint import \
    SuperPointExtractor as JaxSPExt  # noqa: E402
from avlmaps_torch.models.superpoint import (  # noqa: E402
    SuperPointConfig, SuperPointExtractor, params_from_flax)
from avlmaps_torch.tools import loc_eval as tle  # noqa: E402
from avlmaps_torch.tools import pack_scene as tps  # noqa: E402
from avlmaps_torch.tools import planner_eval as tpe  # noqa: E402
from tools import loc_eval as jle  # noqa: E402
from tools import pack_scene as jps  # noqa: E402
from tools import planner_eval as jpe  # noqa: E402
from tools.recall_parity import write_synthetic_scene  # noqa: E402

TIMINGS = ("build_ms_mean", "plan_ms_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, and torch's default of one thread a core makes
    them fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_planner_eval_matches_jax():
    got = tpe.evaluate(n_maps=6, size=120, seed=0)
    want = jpe.evaluate(n_maps=6, size=120, seed=0)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in TIMINGS} == \
        {k: v for k, v in want.items() if k not in TIMINGS}
    assert got["queries"] >= 12 and got["infeasible"] == 0
    assert got["ratio_max"] < 1.05


def test_planner_eval_cli_prints_the_table(capsys):
    assert tpe.main(["--maps", "2", "--size", "80", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[2].startswith("| 2 (80^2) |")


@pytest.fixture(scope="module")
def loc_reports():
    """The JAX tool's report (its own seeded SuperPoint) and the port's
    with the same weights, bridged from the JAX extractor."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jle.main([]) == 0
    want = json.loads(buf.getvalue())
    jsp = JaxSPExt(JaxSPConfig(**tle.SEEDED_SUPERPOINT))
    jsp.extract(np.zeros((1, tle.H, tle.W), np.float32))  # seeded params
    tsp = SuperPointExtractor(SuperPointConfig(**tle.SEEDED_SUPERPOINT),
                              params=params_from_flax(jsp.params),
                              device="cpu")
    return want, tle.evaluate_methods(tsp, device="cpu")


@pytest.mark.parametrize("method", ["orb", "superpoint_mnn"])
def test_loc_eval_matches_jax(loc_reports, method):
    want, got = loc_reports
    assert set(got) == set(want)
    g, w = got[method], want[method]
    assert (g["n"], g["failures"]) == (w["n"], w["failures"]) == (7, 0)
    for key in ("median_err_m", "mean_err_m", "max_err_m"):
        if method == "orb":
            assert g[key] == w[key]
        else:
            assert abs(g[key] - w[key]) <= 1e-3
    assert g["median_err_m"] < 0.05  # each recovers the shifts


def test_loc_eval_cli_runs_on_the_cpu(capsys):
    assert tle.main(["--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["orb"]["failures"] == 0


@pytest.mark.parametrize("flags", [[], ["--no-canvas", "--depth-f32"]],
                         ids=["canvas", "no-canvas-f32"])
def test_pack_scene_cli_writes_the_jax_bytes(tmp_path, flags):
    scene = write_synthetic_scene(tmp_path / "scene", n_frames=3, h=48,
                                  w=64)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jps.main([str(scene), "--out", str(tmp_path / "j.avpack")]
                        + flags) == 0
        assert tps.main([str(scene), "--out", str(tmp_path / "t.avpack")]
                        + flags) == 0
    got = (tmp_path / "t.avpack").read_bytes()
    assert got == (tmp_path / "j.avpack").read_bytes() and len(got) > 0


def test_pack_scene_cli_refuses_a_mismatched_scene(tmp_path, capsys):
    scene = write_synthetic_scene(tmp_path / "scene", n_frames=2)
    next((scene / "depth").glob("*.npy")).unlink()
    assert tps.main([str(scene)]) == 1
    assert "1 depth" in capsys.readouterr().err


@pytest.mark.parametrize("main,argv", [
    ("recall_parity", ["--tiny"]), ("loc_eval", [])])
def test_device_tools_default_to_the_card_and_raise_without_one(
        monkeypatch, main, argv):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"avlmaps_torch.tools.{main}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(argv)


# -- the new modules stand alone ---------------------------------------------

CLIS = ["avlmaps_torch.tools.recall_parity", "avlmaps_torch.tools.loc_eval",
        "avlmaps_torch.tools.planner_eval", "avlmaps_torch.tools.pack_scene",
        "avlmaps_torch.dataset.generate_dataset"]
MODULES = CLIS + ["avlmaps_torch.tools.reference_lseg",
                  "avlmaps_torch.dataset.sound_nav_tasks"]
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "avlmaps_tpu", "tools",
           "dataset")

_PROBE = f"""
import contextlib, importlib, io, json, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(name + " is blocked")
        return None

assert not [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
sys.meta_path.insert(0, Blocker())
out = {{}}
for mod in {MODULES!r}:
    m = importlib.import_module(mod)
    code, buf = None, io.StringIO()
    if hasattr(m, "main"):
        with contextlib.redirect_stdout(buf):
            try:
                m.main(["--help"])
            except SystemExit as e:
                code = e.code
    out[mod] = [code, buf.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def standalone():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_and_answers_help_without_jax(standalone, mod):
    code, text = standalone[mod]
    if mod in CLIS:
        assert code == 0 and text.startswith("usage:")
    else:
        assert code is None
