"""Small surface of the port held to the JAX package's: the loader's pose,
calibration and object-class readers, the profiling helpers and the
``score_features_hbm`` alias.  The readers and the alias are exact."""

import numpy as np
import pytest
import torch

from avlmaps_tpu.pipeline import loader as jloader
from avlmaps_tpu.utils import profiling as jprof
from avlmaps_torch.ops import similarity as tsim
from avlmaps_torch.pipeline import loader as tloader
from avlmaps_torch.utils import profiling as tprof


def test_load_pose_matches_jax(tmp_path, rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    path = tmp_path / "pose.txt"
    path.write_text(" ".join(f"{v:.9f}" for v in
                             np.concatenate([rng.normal(size=3), q]))
                    + "\nignored line\n")
    (gp, gr), (wp, wr) = tloader.load_pose(path), jloader.load_pose(path)
    assert gp.shape == (3, 1) and gr.shape == (3, 3)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gr, wr)


def test_load_calib_matches_jax(tmp_path):
    path = tmp_path / "calib.yaml"
    path.write_text("%YAML:1.0\n---\n"
                    "image_width: 1080\nimage_height: 720\n"
                    "camera_matrix:\n  rows: 3\n  cols: 3\n"
                    "  data: [540.0, 0, 540.0, 0, 540.0, 360.0, 0, 0, 1]\n")
    got, want = tloader.load_calib(path), jloader.load_calib(path)
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)


def test_load_obj2cls_dict_matches_jax(tmp_path):
    path = tmp_path / "obj2cls.txt"
    path.write_text("1: 3, chair\n17:0, void\n\n42: 14 , plant \n"
                    "no separator here\n")
    got, want = tloader.load_obj2cls_dict(path), \
        jloader.load_obj2cls_dict(path)
    assert got == want == {1: (3, "chair"), 17: (0, "void"),
                           42: (14, "plant")}


def test_profiler_and_tic_behave_as_jax(capsys):
    for mod in (tprof, jprof):
        p = mod.Profiler()
        for name in ("a", "b", "a"):
            with p.scope(name):
                pass
        with pytest.raises(ZeroDivisionError):
            with p.scope("c"):
                1 / 0
        assert dict(p.counts) == {"a": 2, "b": 1, "c": 1}
        assert set(p.totals) == {"a", "b", "c"}
        lines = p.summary().splitlines()
        assert len(lines) == 3 and all("calls" in ln for ln in lines)
        p.reset()
        assert p.summary() == ""
        t = mod.Tic()
        t.tic()
        assert t.toc("step") >= 0.0 and t.print_time() >= 0.0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step ") and out[0].endswith("s")
    assert len(out) == 4


def test_score_features_hbm_is_score_features(rng):
    feats = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    text = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    torch.testing.assert_close(
        tsim.score_features_hbm(feats, text, normalize_map=True),
        tsim.score_features(feats, text, normalize_map=True), rtol=0,
        atol=0)
