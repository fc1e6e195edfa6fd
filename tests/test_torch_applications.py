"""The port's CLIs (``python -m avlmaps_torch.application.<name>``) with
``--device cpu`` against the repository's JAX CLIs (application/*.py), run
in-process on copies of one tiny scene with the tiny YAML config of
tests/test_applications.py.  The port's seeded encoders are replaced by
the weights the JAX CLI initialised, through the bridges
(``params_from_flax``), so both sides score with the same CLIP and LSeg.

``create_map``: both write the same files; the area map's poses are
equal and its CLIP features and the visual map's descriptors within
1e-5.  (The two VLMaps hold different voxel sets by design: the port's
``VLMap.create_map`` fuses half-resolution LSeg features.)
``index_map`` (headless, ``--type object``) and ``generate_obstacle_map``
on copies of the JAX-built scene: the same images (the heat's u8 levels
within one step where the f32 heats straddle a level)."""

import pickle
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import avlmaps_torch.models.clip as tclip
import avlmaps_torch.models.lseg as tlseg
from avlmaps_tpu.map.vlmap import VLMap as JaxVLMap
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_torch.application import create_map as t_create
from avlmaps_torch.application import generate_obstacle_map as t_obstacles
from avlmaps_torch.application import index_map as t_index
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.map import hdf5

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from application import create_map as j_create  # noqa: E402
from application import generate_obstacle_map as j_obstacles  # noqa: E402
from application import index_map as j_index  # noqa: E402
from tests.test_applications import _run_cli  # noqa: E402

H, W = 32, 32
SCENE = Path("avlmaps_dataset") / "scene_000"


def write_root(root: Path) -> Path:
    """tests/test_applications.py's scene and config under ``root``."""
    rng = np.random.default_rng(0)
    scene = root / SCENE
    (scene / "rgb").mkdir(parents=True)
    (scene / "depth").mkdir()
    poses = []
    for i in range(3):
        rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        cv2.imwrite(str(scene / "rgb" / f"{i:06d}.png"), rgb)
        np.save(scene / "depth" / f"{i:06d}.npy",
                rng.uniform(0.3, 1.5, (H, W)).astype(np.float32))
        poses.append([0.05 * i, 0, 0, 0, 0, 0, 1.0])
    np.savetxt(scene / "poses.txt", np.asarray(poses))
    # as tests/test_applications.py's, with the 32x32 frames' intrinsics
    # (the default 1080x720 camera puts every point off the canvas)
    calib = ", ".join(str(v) for v in get_sim_cam_mat(H, W).reshape(-1))
    (root / "tiny.yaml").write_text(
        "params:\n  gs: 100\nmap_config:\n  capacity: 20000\n"
        "  depth_sample_rate: 4\n  max_pts_per_frame: 256\n"
        "  lseg_base_size: 32\n  lseg_crop_size: 32\n  lseg_arch: tiny16\n"
        f"  clip_variant: tiny\n  cam_calib_mat: [{calib}]\n")
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Both packages' ``create_map`` on copies of one scene.  The JAX CLI
    runs first; the tiny CLIP and tiny16 LSeg weights it initialises are
    recorded and handed to the port's ``ClipEncoder("tiny")`` and
    ``init_params`` (through ``params_from_flax``) for the whole module."""
    base = tmp_path_factory.mktemp("cli_pair")
    jroot = write_root(base / "jax")
    troot = base / "torch"
    shutil.copytree(jroot, troot)

    seen = {}
    jax_lseg, jax_clip_init = (JaxVLMap._default_lseg,
                               JaxClipEncoder.__init__)

    def recording_lseg(self):
        seen["lseg"] = jax_lseg(self)[1]
        return self._lseg

    def recording_clip_init(self, variant="ViT-B/32", *args, **kw):
        jax_clip_init(self, variant, *args, **kw)
        if variant == "tiny":
            seen["clip"] = self.params

    with pytest.MonkeyPatch.context() as record:
        record.setattr(JaxVLMap, "_default_lseg",
                       recording_lseg)
        record.setattr(JaxClipEncoder, "__init__", recording_clip_init)
        _run_cli(j_create.main, ["create_map.py", "--data-dir", str(jroot),
                                 "--config", str(jroot / "tiny.yaml")])
    clip_params = tclip.params_from_flax(seen["clip"])
    lseg_params = tlseg.params_from_flax(seen["lseg"])

    class BridgedClip(tclip.ClipEncoder):
        def __init__(self, variant="ViT-B/32", params=None, *args, **kw):
            if variant == "tiny" and params is None:
                params = clip_params
            super().__init__(variant, params, *args, **kw)

    def bridged_init(cfg, generator=None):
        assert cfg.out_dim == 24
        return dict(lseg_params)

    with pytest.MonkeyPatch.context() as bridge:
        bridge.setattr(tclip, "ClipEncoder", BridgedClip)
        bridge.setattr(tlseg, "init_params", bridged_init)
        t_create.main(["--data-dir", str(troot), "--config",
                       str(troot / "tiny.yaml"), "--device", "cpu"])
        # the queries run on copies of the JAX-built scene
        qj, qt = base / "query_jax", base / "query_torch"
        shutil.copytree(jroot, qj)
        shutil.copytree(jroot, qt)
        yield jroot, troot, qj, qt


def test_create_map_writes_the_same_artifacts(roots):
    jroot, troot = roots[:2]
    js, ts = jroot / SCENE, troot / SCENE
    names = sorted(str(p.relative_to(js)) for p in js.rglob("*")
                   if p.is_file())
    assert names == sorted(str(p.relative_to(ts)) for p in ts.rglob("*")
                           if p.is_file())
    assert "vlmap/vlmaps.h5df" in names
    area = "area_map/clip_sparse_map.h5df"
    ja, ta = hdf5.read(js / area), hdf5.read(ts / area)
    np.testing.assert_array_equal(ta["robot_pose_list"],
                                  ja["robot_pose_list"])
    np.testing.assert_allclose(ta["clip_sparse_map"], ja["clip_sparse_map"],
                               rtol=0, atol=1e-5)
    desc = [p for p in names if p.startswith("visual_map/global")]
    assert desc
    for p in desc:
        for key, want in hdf5.read(js / p).items():
            np.testing.assert_allclose(hdf5.read(ts / p)[key], want,
                                       rtol=0, atol=1e-5)
    for p in (p for p in names if p.endswith(".pkl")):
        with open(js / p, "rb") as f, open(ts / p, "rb") as g:
            assert pickle.load(f).keys() == pickle.load(g).keys()
    tv = hdf5.read(ts / "vlmap" / "vlmaps.h5df")
    jv = hdf5.read(js / "vlmap" / "vlmaps.h5df")
    assert tv["grid_feat"].shape[1] == 24 and tv["grid_pos"].shape[0] > 0
    assert jv["grid_pos"].shape[0] > 0
    np.testing.assert_array_equal(tv["mapped_iter_list"],
                                  jv["mapped_iter_list"])


@pytest.mark.parametrize("query", ["chair", "table"])
def test_index_map_headless_matches_jax(roots, query):
    qj, qt = roots[2:]
    outs = []
    for main, root, extra in ((j_index.main, qj, []),
                              (t_index.main, qt, ["--device", "cpu"])):
        out = root / f"heat_{query}.png"
        argv = ["--data-dir", str(root), "--config", str(root / "tiny.yaml"),
                "--type", "object", "--query", query, "--out", str(out)]
        if main is j_index.main:
            _run_cli(main, ["index_map.py"] + argv)
        else:
            main(argv + extra)
        outs.append(cv2.imread(str(out)))
    want, got = outs
    assert got.shape == want.shape and len(np.unique(want)) > 2
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got == want).mean() > 0.99


def test_generate_obstacle_map_matches_jax(roots):
    qj, qt = roots[2:]
    images = []
    for main, root in ((j_obstacles.main, qj), (t_obstacles.main, qt)):
        prefix = root / "obstacles"
        argv = ["--data-dir", str(root), "--config", str(root / "tiny.yaml"),
                "--out-prefix", str(prefix)]
        if main is j_obstacles.main:
            _run_cli(main, ["generate_obstacle_map.py"] + argv)
        else:
            main(argv + ["--device", "cpu"])
        images.append([cv2.imread(f"{prefix}_{kind}.png")
                       for kind in ("raw", "customized")])
    for got, want in zip(images[1], images[0]):
        np.testing.assert_array_equal(got, want)


def test_pack_first_writes_a_matching_pack(tmp_path):
    from avlmaps_torch.pipeline.packed import open_matching

    root = write_root(tmp_path)
    scene = root / SCENE
    t_create.pack_first(scene)
    rgb = sorted((scene / "rgb").glob("*.png"))
    depth = sorted((scene / "depth").glob("*.npy"))
    packed = open_matching(scene, rgb, depth)
    assert packed is not None and packed.n == 3
    assert tuple(packed.canvas_hw) == (520, 520)


def test_clis_default_to_cuda(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = write_root(tmp_path)
    for main in (t_create.main, t_index.main, t_obstacles.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["--data-dir", str(root), "--config",
                  str(root / "tiny.yaml"), "--type", "object", "--query",
                  "chair"] if main is t_index.main else
                 ["--data-dir", str(root), "--config",
                  str(root / "tiny.yaml")])
