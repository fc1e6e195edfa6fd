"""The port's dataset tooling (avlmaps_torch/dataset) against the JAX
package's scripts (dataset/generate_dataset.py, dataset/sound_nav_tasks.py)
on the same synthetic inputs.  Everything here is host numpy, OpenCV and
wav files in both, so results are equal: arrays, files and JSON.
"""

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from avlmaps_tpu.config import load_config as jax_load_config  # noqa: E402
from avlmaps_tpu.dataloader.habitat_dataloader import \
    VLMapsDataloaderHabitat as JaxDataloader  # noqa: E402
from avlmaps_tpu.map.vlmap import VLMap as JaxVLMap  # noqa: E402
from avlmaps_tpu.utils.audio import write_wav  # noqa: E402
from avlmaps_tpu.utils.esc50 import ESC50Meta as JaxESC50Meta  # noqa: E402
from avlmaps_torch.config import load_config  # noqa: E402
from avlmaps_torch.dataloader.habitat_dataloader import \
    VLMapsDataloaderHabitat  # noqa: E402
from avlmaps_torch.dataset import generate_dataset as tgen  # noqa: E402
from avlmaps_torch.dataset import sound_nav_tasks as tsnt  # noqa: E402
from avlmaps_torch.map.vlmap import VLMap  # noqa: E402
from avlmaps_torch.map.voxel_map import save_3d_map  # noqa: E402
from avlmaps_torch.utils.esc50 import ESC50Meta  # noqa: E402
from dataset import generate_dataset as jgen  # noqa: E402
from dataset import sound_nav_tasks as jsnt  # noqa: E402

GS, CS, VH = 48, 0.1, 6


def _walks():
    """The straight-line walk of tests/test_dataset_utils.py and a random
    walk that turns back on itself."""
    line = np.zeros((500, 7))
    line[:, 0] = np.arange(500) * 0.02  # 2 cm per frame
    rng = np.random.default_rng(3)
    turn = np.zeros((600, 7))
    turn[:, :3] = np.cumsum(rng.normal(scale=0.05, size=(600, 3)), axis=0)
    turn[:, 6] = 1.0
    return [line, turn]


@pytest.mark.parametrize("walk", [0, 1], ids=["line", "turning"])
def test_select_audio_frames_matches_jax(walk):
    poses = _walks()[walk]
    avoid = np.full((1, 3), np.inf, np.float32)
    pairs, avoid2 = tgen.select_audio_frames(poses, avoid, fps=25,
                                             min_dist=2.0)
    jpairs, javoid2 = jgen.select_audio_frames(poses, avoid, fps=25,
                                               min_dist=2.0)
    assert pairs == jpairs and len(pairs) >= 1
    np.testing.assert_array_equal(avoid2, javoid2)
    # a second sequence avoids the first one's sound positions alike
    more, _ = tgen.select_audio_frames(poses[::-1], avoid2, fps=25,
                                       min_dist=1.0)
    assert more == jgen.select_audio_frames(poses[::-1], javoid2, fps=25,
                                            min_dist=1.0)[0]


def _esc50(root: Path, sr: int):
    audio_dir = root / "esc"
    audio_dir.mkdir()
    rows = ["filename,fold,target,category,esc10,src_file,take"]
    rng = np.random.default_rng(2)
    for i, cat in enumerate(["dog", "dog", "rain"]):
        name = f"1-{100032 + i}-A-{i}.wav"
        write_wav(audio_dir / name,
                  (0.3 * rng.normal(size=sr // 2)).astype(np.float32), sr)
        rows.append(f"{name},1,{i},{cat},True,{100032 + i},A")
    meta = root / "esc50.csv"
    meta.write_text("\n".join(rows) + "\n")
    return meta, audio_dir


def test_assign_sounds_to_sequence_matches_jax(tmp_path):
    """The same clips mixed into the same slots: the same audio.wav bytes
    and meta file (tests/test_dataset_utils.py's inputs, three clips in
    two categories, three slots)."""
    sr = 4000
    meta, audio_dir = _esc50(tmp_path, sr)
    out = {}
    for name, mod, esc in (("jax", jgen, JaxESC50Meta(meta, audio_dir)),
                           ("torch", tgen, ESC50Meta(meta, audio_dir))):
        seq = tmp_path / name / "seq"
        seq.mkdir(parents=True)
        np.savetxt(seq / "poses.txt",
                   np.tile([0, 0, 0, 0, 0, 0, 1.0], (100, 1)))
        mod.assign_sounds_to_sequence(
            seq, esc, ["dog", "rain"], [(0, 30), (40, 60), (70, 99)],
            fps=25, sample_rate=sr, rng=np.random.default_rng(0),
            difficulty_level="level_3")
        out[name] = ((seq / "audio.wav").read_bytes(),
                     (seq / "range_and_audio_meta_level_3.txt").read_text())
    assert out["torch"] == out["jax"]
    assert "dog" in out["torch"][1] or "rain" in out["torch"][1]


def test_render_stages_skip_alike_without_habitat(tmp_path):
    pytest.importorskip("cv2")
    assert not tgen.HABITAT_AVAILABLE and not jgen.HABITAT_AVAILABLE
    said = []
    for name, mod, cfg in (("jax", jgen, jax_load_config()),
                           ("torch", tgen, load_config())):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.generate_scene_data(tmp_path / name, Path("/scenes/x.glb"),
                                    np.zeros((3, 7)), data_cfg=cfg.data_cfg)
        said.append(buf.getvalue())
        assert not (tmp_path / name).exists()
    assert said[0] == said[1] and "skipping scene rendering" in said[0]


def test_fetch_dataset_gates_alike(tmp_path, monkeypatch):
    import builtins

    present = tmp_path / "have"
    (present / "avlmaps_dataset").mkdir(parents=True)
    assert tgen.fetch_dataset(present) == jgen.fetch_dataset(present)
    real_import = builtins.__import__

    def no_gdown(name, *a, **k):
        if name == "gdown":
            raise ImportError("no gdown")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gdown)
    errors = []
    for mod in (jgen, tgen):
        with pytest.raises(RuntimeError, match="gdown") as e:
            mod.fetch_dataset(tmp_path / "missing")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- sound-navigation tasks --------------------------------------------------


def _configure(cfg):
    mc = cfg.map_config
    mc.grid_size, mc.cell_size = GS, CS
    mc.pose_info.camera_height = 0.5
    return mc


def _write_nav_scene(root: Path) -> None:
    """A voxel map, the scene's poses and three audio-video sequences whose
    range meta names a category and a frame range each."""
    rng = np.random.default_rng(5)
    n = 300
    flat = rng.choice(GS * GS * VH, n, replace=False)
    pos = np.stack(np.unravel_index(flat, (GS, GS, VH)), 1).astype(np.int32)
    occupied = -np.ones((GS, GS, VH), np.int32)
    occupied[pos[:, 0], pos[:, 1], pos[:, 2]] = np.arange(n)
    (root / "vlmap").mkdir(parents=True)
    save_3d_map(root / "vlmap" / "vlmaps.h5df",
                rng.normal(size=(n, 8)).astype(np.float32), pos,
                np.ones(n, np.float32), occupied, range(3),
                rng.integers(0, 255, (n, 3), dtype=np.uint8))
    ident = [0, 0, 0, 0, 0, 0, 1.0]
    np.savetxt(root / "poses.txt", np.tile(ident, (3, 1)))
    for s in range(3):
        seq = root / "audio_video" / f"{s:06d}"
        seq.mkdir(parents=True)
        walk = np.tile(ident, (60, 1))
        walk[:, 0] = np.linspace(-1.5, 1.5, 60) * (1 if s % 2 else -1)
        walk[:, 2] = np.linspace(-1.2, 1.2, 60) * (s - 1)
        np.savetxt(seq / "poses.txt", walk)
        (seq / "range_and_audio_meta_level_3.txt").write_text("\n".join(
            f"{a},{a + 15},/esc/{a}.wav,{cat}" for a, cat in
            [(0, "dog"), (20 + s, "rain"), (40, "siren")][:s + 1]))


@pytest.fixture(scope="module")
def nav(tmp_path_factory):
    root = tmp_path_factory.mktemp("sound_nav")
    _write_nav_scene(root / "jax")
    shutil.copytree(root / "jax", root / "torch")
    jmc = _configure(jax_load_config())
    jvm = JaxVLMap(jmc)
    assert jvm.load_map(root / "jax")
    tvm = VLMap(_configure(load_config()), device="cpu")
    assert tvm.load_map(root / "torch")
    return (root, JaxDataloader(root / "jax", jmc, jvm),
            VLMapsDataloaderHabitat(root / "torch", tvm.map_config, tvm))


def test_gt_categories_tracks_and_start_poses_match_jax(nav):
    root, jdl, tdl = nav
    seq = "audio_video/000002"
    cats, tracks = tsnt.load_audio_video_gt_cat_and_poses(
        root / "torch" / seq, tdl)
    assert (cats, tracks) == jsnt.load_audio_video_gt_cat_and_poses(
        root / "jax" / seq, jdl)
    assert cats == ["dog", "rain", "siren"] and all(tracks)
    starts = tsnt.auto_generate_start_poses(tdl, tracks, poses_num=12,
                                            radius_pix=5, seed=3)
    assert starts == jsnt.auto_generate_start_poses(jdl, tracks,
                                                    poses_num=12,
                                                    radius_pix=5, seed=3)


def test_goal_filter_and_goal_sequence_match_jax(nav):
    _, _, tdl = nav
    rng = np.random.default_rng(8)
    goals = [rng.integers(0, 200, (int(rng.integers(0, 6)), 2))
             for _ in range(12)]
    for start in rng.integers(0, 200, (6, 2)):
        for band in [(0, 50), (20, 100), (60, 61)]:
            np.testing.assert_array_equal(
                tsnt.filter_goals_with_distance(start, goals, band),
                jsnt.filter_goals_with_distance(start, goals, band))
        for n_goals in (1, 3, 20):
            assert tsnt.select_goal_sequence(start, goals, n_goals) == \
                jsnt.select_goal_sequence(start, goals, n_goals)


def test_written_task_file_matches_jax(nav):
    root, jdl, tdl = nav
    got = tsnt.write_sound_nav_tasks(root / "torch", tdl, tasks_per_scene=8,
                                     goals_per_task=2, seed=1)
    want = jsnt.write_sound_nav_tasks(root / "jax", jdl, tasks_per_scene=8,
                                      goals_per_task=2, seed=1)
    assert got.name == want.name == "spatial_goal_navigation_tasks.json"
    assert got.read_text() == want.read_text()
    tasks = json.loads(got.read_text())
    assert tasks and all(t["goals"] for t in tasks)
