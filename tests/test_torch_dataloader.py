"""The port's host geometry (avlmaps_torch/geometry: the pose transforms and
the grid converters) and its habitat pose dataloader against the JAX
package's, on the CPU.  Everything here is host numpy in both packages,
so results are exact.
"""

import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.dataloader.habitat_dataloader import \
    VLMapsDataloaderHabitat as JaxDataloader
from avlmaps_tpu.geometry import grid as jgrid
from avlmaps_tpu.geometry import transforms as jtf
from avlmaps_tpu.map.vlmap import VLMap as JaxVLMap
from avlmaps_torch.config import load_config
from avlmaps_torch.dataloader.habitat_dataloader import \
    VLMapsDataloaderHabitat
from avlmaps_torch.geometry import grid as tgrid
from avlmaps_torch.geometry import transforms as ttf
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.map.voxel_map import save_3d_map

GS, CS, VH = 40, 0.1, 6


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return [jtf.quat_xyzw_to_matrix(v) for v in q]


def test_matrix_to_quat_round_trips_like_jax(rng):
    rots = _rotations(rng, 16)
    rots += [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
             np.diag([-1.0, -1.0, 1.0])]  # each branch of Shepperd's method
    for rot in rots:
        got = ttf.matrix_to_quat_xyzw(rot)
        np.testing.assert_array_equal(got, jtf.matrix_to_quat_xyzw(rot))
        np.testing.assert_allclose(ttf.quat_xyzw_to_matrix(got), rot,
                                   atol=1e-12)


def test_pose_helpers_match_jax(rng):
    for rot in _rotations(rng, 8):
        tf = np.eye(4)
        tf[:3, :3] = rot
        tf[:3, 3] = rng.normal(size=3)
        np.testing.assert_array_equal(ttf.tf_to_pose_vec(tf),
                                      jtf.tf_to_pose_vec(tf))
        assert ttf.base_rot_mat_to_theta(rot) == \
            jtf.base_rot_mat_to_theta(rot)
        base = ttf.build_base_transform((0, 0, -1), (-1, 0, 0), (0, 1, 0))
        np.testing.assert_array_equal(ttf.conjugate_base_tf(base, tf),
                                      jtf.conjugate_base_tf(base, tf))
    for theta in (0.0, 0.3, -2.9, np.pi):
        np.testing.assert_array_equal(
            ttf.theta_to_tf2d(theta, (1.0, -2.0, 0.5)),
            jtf.theta_to_tf2d(theta, (1.0, -2.0, 0.5)))


# positions on and around negative cell edges: x / cs = -1.4, -0.5, -1.0
# (a float just off the edge), 1.4 and 0
EDGES = [-0.14, -0.05, -0.1, -0.1000001, -0.0999999, 0.14, 0.0, -2.37, 3.05]


def test_scalar_and_batch_grid_ids_match_jax_at_cell_edges():
    """The scalar converter truncates twice and the batch one once: they
    disagree at negative non-integer x / cs, as in the JAX package."""
    pos = np.array([[x, y, abs(x)] for x in EDGES for y in EDGES])
    scalar = np.array([tgrid.base_pos_to_grid_id_scalar(GS, CS, *p)
                       for p in pos])
    np.testing.assert_array_equal(
        scalar, [jgrid.base_pos_to_grid_id(GS, CS, *p) for p in pos])
    batch = tgrid.base_pos_to_grid_id_batch(GS, CS, pos)
    np.testing.assert_array_equal(
        batch, jgrid.base_pos_to_grid_id_batch(GS, CS, pos))
    assert batch.dtype == np.int32
    assert (scalar != batch).any()  # the two roundings do differ
    # the tensor form (the voxel fusion's) is the scalar form
    tensor = tgrid.base_pos_to_grid_id(GS, CS, torch.from_numpy(pos))
    np.testing.assert_array_equal(tensor.numpy(), scalar)


def test_inverse_and_2d_converters_match_jax(rng):
    ids = rng.integers(-5, GS + 5, (50, 3))
    np.testing.assert_array_equal(
        tgrid.grid_id_to_base_pos_batch(ids, CS, GS),
        jgrid.grid_id_to_base_pos_batch(ids, CS, GS))
    np.testing.assert_array_equal(
        tgrid.grid_id_to_cam_pos_batch(ids, 1.5, CS, GS),
        jgrid.grid_id_to_cam_pos_batch(ids, 1.5, CS, GS))
    for r, c, h in ids[:10]:
        assert tgrid.grid_id_to_base_pos(r, c, h, CS, GS) == \
            jgrid.grid_id_to_base_pos(r, c, h, CS, GS)
        assert tgrid.grid_id_to_pos_2d(GS, CS, r, c) == \
            jgrid.grid_id_to_pos_2d(GS, CS, r, c)
    for x in EDGES:
        for y in EDGES:
            assert tgrid.pos_to_grid_id_2d(GS, CS, x, y) == \
                jgrid.pos_to_grid_id_2d(GS, CS, x, y)


def _configure(cfg):
    mc = cfg.map_config
    mc.grid_size, mc.cell_size = GS, CS
    mc.pose_info.camera_height = 0.5
    return mc


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("dataloader_scene")
    n = 400
    flat = rng.choice(GS * GS * VH, n, replace=False)
    pos = np.stack(np.unravel_index(flat, (GS, GS, VH)), 1).astype(np.int32)
    occupied = -np.ones((GS, GS, VH), np.int32)
    occupied[pos[:, 0], pos[:, 1], pos[:, 2]] = np.arange(n)
    (root / "vlmap").mkdir()
    save_3d_map(root / "vlmap" / "vlmaps.h5df",
                rng.normal(size=(n, 8)).astype(np.float32), pos,
                np.ones(n, np.float32), occupied, range(3),
                rng.integers(0, 255, (n, 3), dtype=np.uint8))
    quat = rng.normal(size=(5, 4))
    np.savetxt(root / "poses.txt", np.concatenate(
        [rng.normal(size=(5, 3)), quat / np.linalg.norm(quat, axis=1,
                                                        keepdims=True)], 1))
    jmc = _configure(jax_load_config())
    jvm = JaxVLMap(jmc)
    assert jvm.load_map(root)
    tvm = VLMap(_configure(load_config()), device="cpu")
    assert tvm.load_map(root)
    return (root, JaxDataloader(root, jmc, jvm),
            VLMapsDataloaderHabitat(root, tvm.map_config, tvm))


def _habitat_tfs(rng, n=12):
    out = []
    for rot in _rotations(rng, n):
        tf = np.eye(4)
        tf[:3, :3] = rot
        tf[:3, 3] = rng.uniform(-1.5, 1.5, 3)
        out.append(tf)
    return out


def test_dataloader_state_matches_jax(scene):
    _, jdl, tdl = scene
    for key in ("rmin", "rmax", "cmin", "cmax"):
        assert getattr(tdl, key) == getattr(jdl, key)
    np.testing.assert_array_equal(tdl.obstacles_cropped,
                                  jdl.obstacles_cropped)
    np.testing.assert_array_equal(tdl.init_base_tf, jdl.init_base_tf)
    np.testing.assert_array_equal(tdl.get_color_topdown_cropped(),
                                  jdl.get_color_topdown_cropped())


def test_habitat_to_map_and_back_matches_jax(scene, rng):
    _, jdl, tdl = scene
    for tf in _habitat_tfs(rng):
        jdl.from_habitat_tf(tf)
        tdl.from_habitat_tf(tf)
        assert tdl.to_full_map_pose() == jdl.to_full_map_pose()
        assert tdl.to_cropped_map_pose() == jdl.to_cropped_map_pose()
        np.testing.assert_array_equal(tdl.to_habitat_tf(),
                                      jdl.to_habitat_tf())
        # and once more from the planar pose the chain gave back
        back = jdl.to_habitat_tf()
        jdl.from_habitat_tf(back)
        tdl.from_habitat_tf(back)
        assert tdl.to_full_map_pose() == jdl.to_full_map_pose()


def test_cropped_and_camera_poses_match_jax(scene, rng):
    _, jdl, tdl = scene
    for dl in (jdl, tdl):
        dl.from_cropped_map_pose(3, 4, 30.0)
    assert tdl.to_full_map_pose() == jdl.to_full_map_pose()
    for dl in (jdl, tdl):
        dl.from_full_map_pose(11, 7, -45.0)
    assert tdl.to_cropped_map_pose() == jdl.to_cropped_map_pose()
    for tf in _habitat_tfs(rng, 4):
        jdl.from_camera_tf(tf)
        tdl.from_camera_tf(tf)
        assert tdl.to_full_map_pose() == jdl.to_full_map_pose()


def test_dataloader_loads_the_map_itself(scene):
    root, jdl, _ = scene
    tdl = VLMapsDataloaderHabitat(root, _configure(load_config()),
                                  device="cpu")
    np.testing.assert_array_equal(tdl.obstacles, jdl.obstacles)
    with pytest.raises(AssertionError, match="from_xx"):
        VLMapsDataloaderHabitat(root, _configure(load_config()),
                                device="cpu").to_full_map_pose()


@pytest.mark.parametrize("packed", [False, True])
def test_rgb_reader_matches_jax(tmp_path, packed):
    """The area map's frame reader: the memmap of a matching
    ``scene.avpack``, else the PNG decode, in both packages."""
    import sys
    from pathlib import Path

    from avlmaps_tpu.pipeline.packed import rgb_reader as jax_rgb_reader
    from avlmaps_torch.pipeline.packed import (open_matching, pack_scene,
                                               rgb_reader)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.recall_parity import write_synthetic_scene

    scene = write_synthetic_scene(tmp_path / "s", n_frames=3)
    rgb = sorted((scene / "rgb").glob("*.png"))
    if packed:
        pack_scene(rgb, sorted((scene / "depth").glob("*.npy")),
                   scene / "scene.avpack")
    assert (open_matching(scene, rgb) is not None) == packed
    got, want = rgb_reader(scene, rgb), jax_rgb_reader(scene, rgb)
    for i in range(3):
        frame = got(i)
        assert frame.dtype == np.uint8 and frame.shape == (32, 32, 3)
        np.testing.assert_array_equal(frame, want(i))
