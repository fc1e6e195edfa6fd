"""The port's visual map (avlmaps_torch/map/visual_map.py) against the JAX
package's, on the CPU.

The metric refinement runs on the JAX package's textured scene
(tests/test_visual_map.py: a 240x320 canvas of rectangles at 2 m, the
query camera moved 25 cm along x), with ORB, with SuperPoint (seeded
narrow weights bridged from flax) + the mutual-NN matcher, and with
SuperPoint + a SuperGlue-interface stub that runs the real Sinkhorn and
decision rule on descriptor similarities.  Each pose is held to the
truth and to the JAX package's pose within JAX's own tolerances (6 cm on
the translation, 0.05 on the rotation); ORB poses are equal to 1e-9
(both packages call OpenCV on the same gray pixels).  The descriptor
cache is read across packages through h5py; ``_to_gray`` is OpenCV's
uint8 rounding bit for bit.
"""

import shutil
import sys
from pathlib import Path

import cv2
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.geometry.transforms import pose_vec_to_tf
from avlmaps_tpu.map.visual_map import VisualMap as JaxVisualMap
from avlmaps_tpu.models import superglue as jsg
from avlmaps_tpu.models.netvlad import NetVLADConfig as JaxNVConfig
from avlmaps_tpu.models.netvlad import NetVLADEncoder as JaxNVEncoder
from avlmaps_tpu.models.superpoint import SuperPointConfig as JaxSPConfig
from avlmaps_tpu.models.superpoint import SuperPointExtractor as JaxSPExt
from avlmaps_torch.config import load_config
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.map import visual_map as tvm
from avlmaps_torch.map.visual_map import VisualMap, rgb_to_gray_u8
from avlmaps_torch.models import superglue as tsg
from avlmaps_torch.models.netvlad import (NetVLADConfig, NetVLADEncoder,
                                          params_from_flax as nv_from_flax)
from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                             SuperPointExtractor,
                                             params_from_flax as sp_from_flax)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests.test_visual_map import (DEPTH, H, TX, W,  # noqa: E402
                                   textured_canvas)

SP = dict(channels=(8, 8, 16, 16), det_ch=32, desc_ch=32, desc_dim=32,
          max_keypoints=512, score_threshold=0.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("tvmap") / "scene"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    fx = get_sim_cam_mat(H, W)[0, 0]
    shift = int(round(fx * TX / DEPTH))
    tex = textured_canvas(rng, H, W + shift)
    cv2.imwrite(str(root / "rgb" / "000000.png"), tex[:, :W, ::-1])
    np.save(root / "depth" / "000000.npy", np.full((H, W), DEPTH,
                                                   np.float32))
    np.savetxt(root / "poses.txt", np.asarray([[0, 0, 0, 0, 0, 0, 1.0]]))
    return root, np.ascontiguousarray(tex[:, shift:W + shift])


def _config(load):
    cfg = load()
    cfg.map_config.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
    return cfg.map_config


def _pair(root, jax_kw=None, torch_kw=None):
    """Both packages' visual maps on the scene, retrieval trivially 0."""
    maps = (JaxVisualMap(_config(jax_load_config), str(root),
                         **(jax_kw or {})),
            VisualMap(_config(load_config), str(root), device="cpu",
                      **(torch_kw or {})))
    for m in maps:
        m.data_dir = Path(root)
        m.poses = np.stack([pose_vec_to_tf([0, 0, 0, 0, 0, 0, 1.0])])
        m.descriptors = np.ones((1, 8), np.float32)
    return maps


def _assert_recovers(cam_tf, m):
    assert cam_tf is not None, "PnP refinement failed"
    expected = m._ref_cam_tf(0)
    np.testing.assert_allclose(cam_tf[:3, 3] - expected[:3, 3], [TX, 0, 0],
                               atol=0.06)
    np.testing.assert_allclose(cam_tf[:3, :3], expected[:3, :3], atol=0.05)


def _assert_close_poses(got, want):
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=0.06)
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=0.05)


def test_to_gray_is_opencv_bit_for_bit():
    """Every one of the 2^24 RGB triples."""
    v = np.arange(256, dtype=np.uint8)
    r, g = np.meshgrid(v, v, indexing="ij")
    for b in range(256):
        img = np.stack([r, g, np.full_like(r, b)], -1)
        np.testing.assert_array_equal(rgb_to_gray_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    with pytest.raises(ValueError, match="uint8"):
        rgb_to_gray_u8(img.astype(np.float32))


def test_refine_orb_matches_jax(scene):
    root, query = scene
    jm, tm = _pair(root)
    intr = get_sim_cam_mat(H, W)
    want, got = jm.refine_pose(query, 0, intr), tm.refine_pose(query, 0,
                                                               intr)
    _assert_recovers(got, tm)
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert tm.refine_pose(np.zeros((H, W, 3), np.uint8), 0, intr) is None


def test_refine_superpoint_mnn_matches_jax(scene):
    root, query = scene
    jsp = JaxSPExt(JaxSPConfig(**SP))
    jsp.extract(np.zeros((1, H, W), np.float32))  # draws its seeded params
    tsp = SuperPointExtractor(SuperPointConfig(**SP),
                              params=sp_from_flax(jsp.params), device="cpu")
    jm, tm = _pair(root, {"superpoint": jsp}, {"superpoint": tsp})
    intr = get_sim_cam_mat(H, W)
    got = tm.refine_pose(query, 0, intr)
    _assert_recovers(got, tm)
    _assert_close_poses(got, jm.refine_pose(query, 0, intr))
    ref_pts, q_pts = tm._match_superpoint(query, 0)
    jref, jq = jm._match_superpoint(query, 0)
    assert len(ref_pts) > 50 and abs(len(ref_pts) - len(jref)) <= 5


class _JaxSimilarityGlue:
    """SuperGlueMatcher-interface stub (tests/test_visual_map.py): unary
    descriptor similarity through the real Sinkhorn and decision rule."""

    def match(self, f0, f1, hw, hw1=None):
        v0, v1 = jnp.asarray(f0["valid"]), jnp.asarray(f1["valid"])
        scores = 100.0 * jnp.einsum("bnd,bmd->bnm",
                                    jnp.asarray(f0["descriptors"]),
                                    jnp.asarray(f1["descriptors"]))
        z = jsg.log_optimal_transport(scores, jnp.asarray(1.0), v0, v1,
                                      iters=20)
        return jsg.match_from_assignment(z, v0, v1, threshold=0.05)


class _TorchSimilarityGlue:
    """The same stub on the port's Sinkhorn and decision rule."""

    def match(self, f0, f1, hw, hw1=None):
        assert len(hw) == 2 and (hw1 is None or len(hw1) == 2)
        v0 = torch.from_numpy(np.asarray(f0["valid"]))
        v1 = torch.from_numpy(np.asarray(f1["valid"]))
        scores = 100.0 * torch.einsum(
            "bnd,bmd->bnm", torch.from_numpy(np.asarray(f0["descriptors"])),
            torch.from_numpy(np.asarray(f1["descriptors"])))
        z = tsg.log_optimal_transport(scores, 1.0, v0, v1, iters=20)
        return tsg.match_from_assignment(z, v0, v1, threshold=0.05)


def test_refine_superglue_stub_matches_jax(scene):
    root, query = scene
    jsp = JaxSPExt(JaxSPConfig(**SP))
    jsp.extract(np.zeros((1, H, W), np.float32))
    tsp = SuperPointExtractor(SuperPointConfig(**SP),
                              params=sp_from_flax(jsp.params), device="cpu")
    jm, tm = _pair(root, {"superpoint": jsp,
                          "superglue": _JaxSimilarityGlue()},
                   {"superpoint": tsp, "superglue": _TorchSimilarityGlue()})
    intr = get_sim_cam_mat(H, W)
    got = tm.refine_pose(query, 0, intr)
    _assert_recovers(got, tm)
    _assert_close_poses(got, jm.refine_pose(query, 0, intr))


def test_localize_image_matches_jax(scene):
    root, query = scene
    jm, tm = _pair(root)
    for m in (jm, tm):
        m.retrieve = lambda img, topk=1: np.array([0])
    (jc, jb), (tc, tb) = jm.localize_image(query), tm.localize_image(query)
    np.testing.assert_allclose(tc, jc, atol=1e-9)
    np.testing.assert_allclose(tb, jb, atol=1e-9)
    assert abs(tc[0, 3] - TX) < 0.06
    assert tb[1, 3] == tc[1, 3] - tm.map_config.pose_info.camera_height


def test_without_opencv_orb_and_the_solve_raise(scene, monkeypatch):
    root, query = scene
    tsp = SuperPointExtractor(SuperPointConfig(**SP), device="cpu")
    _, orb = _pair(root)
    _, sp = _pair(root, torch_kw={"superpoint": tsp})
    monkeypatch.setattr(tvm, "cv2", None)
    intr = get_sim_cam_mat(H, W)
    with pytest.raises(ImportError, match="cv2"):
        orb.refine_pose(query, 0, intr)
    with pytest.raises(ImportError, match="cv2"):
        sp.refine_pose(query, 0, intr)
    sp.retrieve = lambda img, topk=1: np.array([0])
    with pytest.raises(ImportError, match="cv2"):
        sp.localize_image(query)  # not swallowed into the retrieval pose


def test_localize_image_catches_only_solver_errors(scene, monkeypatch):
    root, query = scene
    _, tm = _pair(root)
    tm.retrieve = lambda img, topk=1: np.array([0])

    def solver_fails(*_a, **_k):
        raise cv2.error("degenerate")

    monkeypatch.setattr(tm, "refine_pose", solver_fails)
    cam, _ = tm.localize_image(query)
    np.testing.assert_array_equal(cam, tm._ref_cam_tf(0))

    def device_fault(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tm, "refine_pose", device_fault)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.localize_image(query)


class _FakeEnc:
    """A retrieval encoder of any width: the first ``dim`` pixels."""

    def __init__(self, dim):
        self.feat_dim = dim

    def get_imgs_feats_batch(self, imgs, bs=64):
        return np.stack([np.asarray(i, np.float32).reshape(-1)[:self.feat_dim]
                         / 255.0 for i in imgs])

    def get_img_feats(self, img):
        return self.get_imgs_feats_batch([img])


def _frames_scene(root, n=4):
    (root / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(n):
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"),
                    rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
    poses = np.zeros((n, 7))
    poses[:, 0] = np.arange(n) * 0.5
    poses[:, -1] = 1.0
    np.savetxt(root / "poses.txt", poses)
    return root


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_descriptor_cache_reads_across_packages(tmp_path, writer):
    """visual_map/global_descriptors_<dim>.h5df, dataset 'descriptors':
    written by one package (h5py or the port's codec), read by the other
    and by h5py to the same array."""
    root = _frames_scene(tmp_path / "scene")
    make = {"jax": lambda: JaxVisualMap(jax_load_config().map_config,
                                        clip_encoder=_FakeEnc(12)),
            "torch": lambda: VisualMap(load_config().map_config,
                                       clip_encoder=_FakeEnc(12),
                                       device="cpu")}
    m = make[writer]()
    m.create_and_load_map(root)
    path = root / "visual_map" / "global_descriptors_12.h5df"
    with h5py.File(path, "r") as f:
        want = f["descriptors"][()]
    np.testing.assert_array_equal(want, m.descriptors)
    reader = make["torch" if writer == "jax" else "jax"]()
    reader.clip_encoder = _NoEncode(12)  # must read the cache, not encode
    reader.create_and_load_map(root)
    np.testing.assert_array_equal(reader.descriptors, want)
    np.testing.assert_array_equal(reader.poses, m.poses)


class _NoEncode(_FakeEnc):
    def get_imgs_feats_batch(self, imgs, bs=64):
        raise AssertionError("the cache should have been read")


def test_encoder_switch_preserves_other_cache(tmp_path):
    root = _frames_scene(tmp_path / "scene")
    mc = load_config().map_config
    a = VisualMap(mc, clip_encoder=_FakeEnc(16), device="cpu")
    a.create_and_load_map(root)
    cache_a = root / "visual_map" / "global_descriptors_16.h5df"
    before = cache_a.read_bytes()
    b = VisualMap(mc, clip_encoder=_FakeEnc(32), device="cpu")
    b.create_and_load_map(root)
    assert (root / "visual_map" / "global_descriptors_32.h5df").exists()
    b.descriptors = np.ones((4, 16), np.float32)
    b.retrieve(np.zeros((16, 16, 3), np.uint8))
    assert b.descriptors.shape == (4, 32)
    assert cache_a.read_bytes() == before


def test_retrieve_with_netvlad_matches_jax(tmp_path):
    """The JAX package's NetVLAD retrieval recipe (tests/test_netvlad.py):
    each frame retrieves itself, on bridged tiny weights in both."""
    root = tmp_path / "scene"
    (root / "rgb").mkdir(parents=True)
    imgs = []
    for i in range(4):
        img = np.zeros((16, 16, 3), np.uint8)
        img[:, :4 * (i + 1)] = 255
        imgs.append(img)
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"), img)
    poses = np.zeros((4, 7))
    poses[:, -1] = 1.0
    np.savetxt(root / "poses.txt", poses)
    jenc = JaxNVEncoder(JaxNVConfig.tiny(), image_size=16)
    tenc = NetVLADEncoder(NetVLADConfig.tiny(),
                          params=nv_from_flax(jenc.params), device="cpu")
    jm = JaxVisualMap(jax_load_config().map_config, clip_encoder=jenc)
    jm.create_and_load_map(root)
    shutil.rmtree(root / "visual_map")
    tm = VisualMap(load_config().map_config, clip_encoder=tenc,
                   device="cpu")
    tm.create_and_load_map(root)
    np.testing.assert_allclose(tm.descriptors, jm.descriptors, atol=1e-5)
    for i in range(4):
        assert int(tm.retrieve(imgs[i])[0]) == int(jm.retrieve(imgs[i])[0]) \
            == i
