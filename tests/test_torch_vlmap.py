"""The port's VLMap and AVLMap.index_object against the JAX package's, on
the CPU: a map written by the JAX package's ``save_3d_map`` is loaded by
both packages' VLMap, each with the same tiny CLIP weights.

Masks, obstacle maps, island geometry, goal and top-k positions are
exact (the data is checked to have no near-tie labels: every top-2 score
gap exceeds 1e-4).  Category scores and heat are held at atol 1e-5 (f32
products in another summation order).
"""

import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map.avlmap import AVLMap as JaxAVLMap
from avlmaps_tpu.map.vlmap import VLMap as JaxVLMap
from avlmaps_tpu.map.voxel_map import save_3d_map as jax_save_3d_map
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.ops.delivery import fetch_np as jax_fetch_np
from avlmaps_torch.config import load_config
from avlmaps_torch.map.avlmap import AVLMap
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.models.clip import ClipEncoder, params_from_flax
from avlmaps_torch.ops.delivery import fetch_np

GS, VH, CS, N = 32, 8, 0.05, 700
CATEGORIES = ["void", "chair", "table", "sofa", "objects"]
ATOL = 1e-5


def _configure(cfg):
    cfg.map_config.grid_size = GS
    cfg.map_config.cell_size = CS
    cfg.params.gs = GS
    cfg.params.cs = CS
    cfg.map_config.pose_info.camera_height = CS * VH
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("vlmap_scene")
    flat = rng.choice(GS * GS * VH, N, replace=False)
    pos = np.stack(np.unravel_index(flat, (GS, GS, VH)), 1).astype(np.int32)
    occupied = -np.ones((GS, GS, VH), np.int32)
    occupied[pos[:, 0], pos[:, 1], pos[:, 2]] = np.arange(N)
    feats = rng.normal(size=(N, 24)).astype(np.float32)
    (root / "vlmap").mkdir()
    jax_save_3d_map(root / "vlmap" / "vlmaps.h5df", feats, pos,
                    rng.uniform(0.5, 2, N).astype(np.float32), occupied,
                    range(4), rng.integers(0, 255, (N, 3), dtype=np.uint8))

    jenc = JaxClipEncoder("tiny")
    tenc = ClipEncoder("tiny", params=params_from_flax(jenc.params),
                       device="cpu")
    jvm = JaxVLMap(_configure(jax_load_config()).map_config,
                   clip_encoder=jenc)
    tvm = VLMap(_configure(load_config()).map_config, clip_encoder=tenc,
                device="cpu")
    assert jvm.load_map(root) and tvm.load_map(root)
    return root, jvm, tvm


def _assert_clear(scores):
    s = np.sort(scores, axis=1)
    assert (s[:, -1] - s[:, -2] > 1e-4).all()


def test_load_map_reads_the_jax_file(scene):
    _, jvm, tvm = scene
    for key in ("grid_feat", "grid_pos", "weight", "occupied_ids",
                "grid_rgb"):
        np.testing.assert_array_equal(getattr(tvm, key), getattr(jvm, key))
    assert tvm.mapped_iter_list == jvm.mapped_iter_list


def test_init_categories_and_index_map_agree(scene):
    _, jvm, tvm = scene
    want = jvm.init_categories(CATEGORIES[1:-1])
    got = tvm.init_categories(CATEGORIES[1:-1])
    np.testing.assert_allclose(got, want, atol=ATOL)
    _assert_clear(want)
    for name in ("chair", "sofa", "armchair"):
        np.testing.assert_array_equal(tvm.index_map(name),
                                      jvm.index_map(name))
        got = tvm.index_map(name, with_init_cat=False)
        np.testing.assert_array_equal(
            got, jvm.index_map(name, with_init_cat=False))
        assert got.any()


def test_index_map_needs_categories_first(scene):
    """index_map with the categories asks for them first;
    index_map_sharded needs none: on two CPU shards it gives the JAX
    package's mask on two devices, and index_map's without categories."""
    from avlmaps_torch.parallel import make_mesh
    from avlmaps_tpu.parallel import make_mesh as jax_make_mesh

    vm = VLMap(_configure(load_config()).map_config, device="cpu")
    with pytest.raises(Exception, match="init_categories"):
        vm.index_map("chair")
    _, jvm, tvm = scene
    for name in ("chair", "sofa"):
        got = tvm.index_map_sharded(make_mesh(devices=["cpu"] * 2), name)
        np.testing.assert_array_equal(
            got, jvm.index_map_sharded(jax_make_mesh(2), name))
        np.testing.assert_array_equal(
            got, tvm.index_map(name, with_init_cat=False))


def test_customize_obstacle_map_and_get_pos_agree(scene):
    _, jvm, tvm = scene
    names = ["chair", "table", "sofa"]
    jvm.customize_obstacle_map(names, ["table"])
    tvm.customize_obstacle_map(names, ["table"])
    np.testing.assert_array_equal(tvm.obstacles_map, jvm.obstacles_map)
    np.testing.assert_array_equal(tvm.obstacles_new_cropped,
                                  jvm.obstacles_new_cropped)
    jvm.init_categories(names)
    tvm.init_categories(names)
    got, want = tvm.get_pos("sofa"), jvm.get_pos("sofa")
    assert len(got[0]) == len(want[0]) > 0
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1] and got[2] == want[2]


def _avlmaps(scene):
    root, jvm, tvm = scene
    jm = JaxAVLMap.__new__(JaxAVLMap)  # the object query needs no encoders
    jm.config = _configure(jax_load_config())
    jm.vlmap = jvm
    tm = AVLMap(_configure(load_config()), clip_encoder=tvm.clip_encoder,
                device="cpu")
    assert tm.vlmap.load_map(root)
    return jm, tm


@pytest.mark.parametrize("init_categories", [None, CATEGORIES])
def test_index_object_every_delivery_agrees(scene, init_categories):
    jm, tm = _avlmaps(scene)
    kw = dict(init_categories=init_categories, decay_rate=0.01)
    want = jm.index_object("chair", **kw)
    tm_f32 = tm.index_object("chair", **kw)
    assert isinstance(tm_f32, np.ndarray) and tm_f32.shape == (N,)
    np.testing.assert_allclose(tm_f32, want, atol=ATOL)
    assert (tm_f32 == 1).any()
    np.testing.assert_array_equal(
        tm.index_object("chair", delivery="u8", **kw),
        jm.index_object("chair", delivery="u8", **kw))
    dev = tm.index_object("chair", delivery="device", **kw)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_allclose(dev.numpy(), want, atol=ATOL)
    for a, b in zip(tm.index_object("chair", delivery="topk", **kw),
                    jm.index_object("chair", delivery="topk", **kw)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tm.index_object("chair", delivery="goal", **kw),
        jm.index_object("chair", delivery="goal", **kw))
    with pytest.raises(ValueError, match="delivery"):
        tm.index_object("chair", delivery="f16", **kw)


def test_serving_query_agrees(scene):
    _, jvm, tvm = scene
    keys = ("heat", "goal_pos", "topk_vals", "topk_pos")
    got, want = (tvm.make_serving_query(k=8)("chair"),
                 jvm.make_serving_query(k=8)("chair"))
    got = fetch_np(*(got[k] for k in keys))
    want = jax_fetch_np(*(want[k] for k in keys))
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_heatmap_rgb(scene):
    _, tm = _avlmaps(scene)
    heat = np.linspace(0, 1, N).astype(np.float32)
    rgb = tm.heatmap_rgb(heat)
    assert rgb.shape == (N, 3) and np.isfinite(rgb).all()


@pytest.mark.parametrize("method,args", [
    ("index_image", (np.zeros((8, 8, 3), np.uint8),))])
def test_unported_methods_raise(method, args):
    """Nothing in AVLMap is left unported: the image query goes to the
    port's visual map, which raises before a map is loaded (the query
    itself is held to the JAX package's in
    tests/test_torch_avlmap_modalities.py)."""
    from avlmaps_torch.map.visual_map import VisualMap

    tm = AVLMap(_configure(load_config()), device="cpu")
    assert isinstance(tm.visual_map, VisualMap)
    with pytest.raises(RuntimeError, match="create_and_load_map"):
        getattr(tm, method)(*args)


def test_create_map_builds_a_loadable_map(tmp_path):
    """VLMap.create_map wires the port's builder (whose voxel set
    tests/test_torch_builder.py holds against the JAX package) to its
    default seeded tiny16 LSeg, saves, and load_map reads the map back."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from avlmaps_torch.geometry.projection import get_sim_cam_mat
    from avlmaps_torch.models.lseg import LOGIT_SCALE
    from tools.recall_parity import write_synthetic_scene

    mc = load_config().map_config
    mc.lseg_arch = "tiny16"
    mc.grid_size, mc.cell_size = 64, 0.1
    mc.pose_info.camera_height = 0.8
    mc.capacity, mc.depth_sample_rate, mc.max_pts_per_frame = 16384, 4, 256
    mc.cam_calib_mat = tuple(get_sim_cam_mat(32, 32).reshape(-1))
    mc.lseg_base_size = mc.lseg_crop_size = 32
    vm = VLMap(mc, device="cpu")
    scene = write_synthetic_scene(tmp_path / "scene", n_frames=4)
    vm.create_map(scene, batch_size=2)
    assert vm.load_map(scene)
    n = len(vm.grid_pos)
    assert n > 0 and vm.grid_feat.shape == (n, 24)
    assert vm.occupied_ids.shape == (64, 64, 8)
    pos = vm.grid_pos
    np.testing.assert_array_equal(
        vm.occupied_ids[pos[:, 0], pos[:, 1], pos[:, 2]], np.arange(n))
    norms = np.linalg.norm(vm.grid_feat, axis=1)
    assert np.isfinite(norms).all() and norms.max() <= LOGIT_SCALE * 1.001
