"""The port's multi-floor build and query
(avlmaps_torch/map/vlmap_builder_multi_floor.py) against the JAX package's
on the two-floor 32x32 scene of tests/test_multi_floor.py.

Both builds read the same frames with the same tiny16 LSeg weights
(converted by params_from_flax) and the same seed, so the host draws the
same pixels: bounds within 1e-6, the same voxels, slots and frames,
weights within rtol 1e-6; features within 1e-5 when both builds fuse
the same per-point features (the JAX forward inside the port's build),
and within the single-floor builder test's 1e-4 through each package's
own tiny16 forward.  Each package's ``load_map`` reads the other's file; the
open-vocabulary index runs with the same tiny CLIP weights.
"""

import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map import vlmap_builder_multi_floor as jmf
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_torch.config import load_config
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.map import vlmap_builder_multi_floor as tmf
from avlmaps_torch.models.clip import ClipEncoder, params_from_flax
from avlmaps_torch.models.lseg import LSegConfig, LSegNet
from avlmaps_torch.models.lseg import params_from_flax as lseg_from_flax
from avlmaps_torch.pipeline.packed import pack_scene
from tests.test_multi_floor import H, W, write_scene

CATEGORIES = ["chair", "table", "sofa"]


def _configure(cfg):
    mc = cfg.map_config
    mc.cell_size = 0.1
    mc.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
    mc.capacity = 8192
    mc.depth_sample_rate = 16
    mc.max_pts_per_frame = 64
    mc.lseg_base_size = W
    mc.lseg_crop_size = W
    return mc


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLSegNet(JaxLSegConfig.tiny16())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, H, W, 3), jnp.float32))
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    tnet.load_state_dict(lseg_from_flax(variables), strict=True)
    tnet.eval().requires_grad_(False)
    return jnet, variables, tnet


def _frames(scene):
    return (sorted((scene / "rgb").glob("*.png")),
            sorted((scene / "depth").glob("*.npy")))


def _jax_builder(scene, pose_tfs, nets, **kw):
    jnet, variables, _ = nets
    return jmf.VLMapBuilderMultiFloor(
        scene, _configure(jax_load_config()), *_frames(scene), pose_tfs,
        lseg_apply=jnet.apply, lseg_params=variables, feat_dim=24,
        batch_size=2, **kw)


def _torch_builder(scene, pose_tfs, nets, **kw):
    return tmf.VLMapBuilderMultiFloor(
        scene, _configure(load_config()), *_frames(scene), pose_tfs,
        lseg_apply=nets[2], feat_dim=24, batch_size=2, device="cpu", **kw)


@pytest.fixture(scope="module")
def built(tmp_path_factory, nets):
    root = tmp_path_factory.mktemp("multi_floor")
    scene_j, pose_tfs = write_scene(root / "jax")
    scene_t, _ = write_scene(root / "torch")
    jb = _jax_builder(scene_j, pose_tfs, nets)
    tb = _torch_builder(scene_t, pose_tfs, nets)
    bounds = (jb.probe_bounds(sample_stride=4),
              tb.probe_bounds(sample_stride=4))
    want = jb.create_global_map(progress=False)
    got = tb.create_global_map(progress=False)
    return scene_j, scene_t, pose_tfs, bounds, want, got


def test_probe_bounds_match_jax(built):
    (jmin, jmax), (tmin, tmax) = built[3]
    np.testing.assert_allclose(tmin, jmin, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmax, jmax, rtol=0, atol=1e-6)
    assert tmax[1] - tmin[1] > 1.5  # two floors 1.5 m apart


def test_build_matches_jax(built):
    (fj, pj, wj, oj, rj), (ft, pt, wt, ot, rt) = built[4], built[5]
    assert pt.shape[0] > 0
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_allclose(wt, wj, rtol=1e-6)
    # the two tiny16 forwards differ by ~1e-5 (flax and torch convolution
    # orders): the single-floor builder test's tolerance
    np.testing.assert_allclose(ft, fj, rtol=1e-4, atol=1e-4)
    # colour truncates to uint8 after the division
    assert np.abs(rt.astype(int) - rj).max() <= 1


def test_fusion_matches_jax_on_the_same_features(built, nets, tmp_path):
    """The port's build with the JAX package's own LSeg forward as its
    ``lseg_apply``: every per-point feature is the same, so the fused
    features agree within 1e-5 (f32 weighted sums in another order) and
    the weights within rtol 1e-6."""
    jnet, variables, _ = nets
    pose_tfs = built[2]
    scene, _ = write_scene(tmp_path / "bridged")

    forward = jax.jit(jnet.apply)

    def jax_apply(x):
        out = forward(variables, jnp.asarray(x.numpy()))
        return torch.from_numpy(np.array(out))

    tb = tmf.VLMapBuilderMultiFloor(
        scene, _configure(load_config()), *_frames(scene), pose_tfs,
        lseg_apply=jax_apply, feat_dim=24, batch_size=2, device="cpu")
    tb.probe_bounds(sample_stride=4)
    ft, pt, wt, ot, rt = tb.create_global_map(progress=False)
    fj, pj, wj, oj, rj = built[4]
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-5)
    assert np.abs(rt.astype(int) - rj).max() <= 1


def test_geometry_truncates_toward_zero(built, nets):
    """A point less than a cell below pcd_min lands in row 0 and is fused
    (jnp.trunc, not floor), in both packages; one more than a cell below
    is dropped."""
    scene_j, scene_t, pose_tfs = built[:3]
    jb = _jax_builder(scene_j, pose_tfs, nets)
    tb = _torch_builder(scene_t, pose_tfs, nets)
    cs = tb.map_config.cell_size
    pcd_min = np.array([-0.5, -0.5, -0.5])
    jb.pcd_min = tb.pcd_min = pcd_min
    jgeo = jb._make_geometry(10, 10, H, W, H, W)
    tgeo = tb._make_geometry(10, 10, H, W, H, W)
    idx = np.array([[(H // 2) * W + W // 2]], np.int32)
    z = np.array([[0.6]], np.float32)
    ray = np.linalg.inv(tb.map_config.calib_matrix()) @ np.array(
        [W // 2 + 0.5, H // 2 + 0.5, 1.0])
    for cells, row, ok in ((-0.5, 0, True), (-0.9, 0, True),
                           (-1.5, -1, False), (2.5, 2, True)):
        target = pcd_min + cs * np.array([cells, 2.5, 3.5])
        pose = np.eye(4, dtype=np.float32)[None]
        pose[0, :3, 3] = target - ray * z[0, 0]
        want = [np.asarray(a) for a in jgeo(
            jnp.asarray(z), jnp.asarray(idx), jnp.asarray(pose))]
        got = [a.numpy() for a in tgeo(torch.from_numpy(z),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(pose))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        gid, valid = got[0][0, 0], got[4][0, 0]
        assert list(gid) == [row, 3, 2] and bool(valid) == ok, cells


def test_each_package_loads_the_others_file(built):
    scene_j, scene_t = built[:2]
    jm = jmf.VLMapMultiFloor(_configure(jax_load_config()))
    tm = tmf.VLMapMultiFloor(_configure(load_config()), device="cpu")
    assert tm.load_map(scene_j) and jm.load_map(scene_t)
    (fj, pj, wj, oj, rj), (ft, pt, wt, ot, rt) = built[4], built[5]
    for got, want in ((tm, (fj, pj, wj, oj, rj)), (jm, (ft, pt, wt, ot, rt))):
        for key, w in zip(("grid_feat", "grid_pos", "weight",
                           "occupied_ids", "grid_rgb"), want):
            np.testing.assert_array_equal(getattr(got, key), w)
    np.testing.assert_array_equal(tm.pcd_min, built[3][0][0])
    np.testing.assert_array_equal(jm.pcd_max, built[3][1][1])
    assert tm.cs == jm.cs == 0.1
    assert tm.mapped_iter_list == jm.mapped_iter_list == [0, 1, 2, 3]
    np.testing.assert_array_equal(tm.grid_to_global(tm.grid_pos),
                                  jm.grid_to_global(jm.grid_pos))
    # the port's file, as h5py reads it: h5py's dtypes and a scalar cs
    path = scene_t / "vlmap_multi_floor" / "vlmaps_multi_floor.h5df"
    with h5py.File(path, "r") as f:
        assert f["mapped_iter_list"].dtype == np.int32
        assert f["pcd_min"].dtype == f["pcd_max"].dtype == np.float64
        assert f["cs"].dtype == np.float64 and f["cs"].shape == ()


def test_index_map_and_get_pos_match_jax(built):
    scene_j = built[0]
    jenc = JaxClipEncoder("tiny")
    tenc = ClipEncoder("tiny", params=params_from_flax(jenc.params),
                       device="cpu")
    jm = jmf.VLMapMultiFloor(_configure(jax_load_config()),
                             clip_encoder=jenc)
    tm = tmf.VLMapMultiFloor(_configure(load_config()), clip_encoder=tenc,
                             device="cpu")
    assert jm.load_map(scene_j) and tm.load_map(scene_j)
    want = jm.init_categories(CATEGORIES)
    got = tm.init_categories(CATEGORIES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    s = np.sort(want, axis=1)
    assert (s[:, -1] - s[:, -2] > 1e-4).all()  # no near-tie labels
    for name in CATEGORIES:
        mask = tm.index_map(name)
        np.testing.assert_array_equal(mask, jm.index_map(name))
        np.testing.assert_array_equal(
            tm.index_map(name, with_init_cat=False),
            jm.index_map(name, with_init_cat=False))
        tc, tcent, tbox = tm.get_pos(name)
        jc, jcent, jbox = jm.get_pos(name)
        assert tcent == jcent and tbox == jbox
        assert len(tc) == len(jc)
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)


def test_packed_matches_decoded(tmp_path, nets):
    plain, pose_tfs = write_scene(tmp_path / "plain")
    packed, _ = write_scene(tmp_path / "packed")
    pack_scene(*_frames(packed), packed / "scene.avpack", depth_dtype="f32")
    maps = []
    for scene in (plain, packed):
        b = _torch_builder(scene, pose_tfs, nets)
        b.probe_bounds(sample_stride=4)
        maps.append(b.create_global_map(progress=False))
    (f1, p1, w1, o1, r1), (f2, p2, w2, o2, r2) = maps
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_array_equal(o2, o1)
    np.testing.assert_allclose(w2, w1, rtol=1e-6)
    np.testing.assert_allclose(f2, f1, rtol=1e-5, atol=1e-6)


def test_mesh_raises_and_missing_map(tmp_path, nets):
    with pytest.raises(NotImplementedError, match="item 11"):
        _torch_builder(tmp_path, [np.eye(4)], nets, mesh=object())
    m = tmf.VLMapMultiFloor(_configure(load_config()), device="cpu")
    assert not m.load_map(tmp_path)


def test_probe_sees_every_tenth_stride_of_frames(tmp_path, nets):
    """probe_bounds reads frames 0, s//10, 2(s//10), ... and every s-th
    valid point of each, as the JAX package does: the two agree on a
    stride that skips frames."""
    scene, pose_tfs = write_scene(tmp_path / "s", n_frames=6)
    jb = _jax_builder(scene, pose_tfs, nets)
    tb = _torch_builder(scene, pose_tfs, nets)
    for stride in (20, 50):
        for got, want in zip(tb.probe_bounds(sample_stride=stride),
                             jb.probe_bounds(sample_stride=stride)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    shutil.rmtree(scene)


@pytest.mark.parametrize("n", [0, 9, 17, 40])
def test_hdf5_codec_writes_groups_of_any_size(tmp_path, n):
    """The multi-floor file holds nine datasets: more than one
    symbol-table node.  h5py reads (and looks up by name) every dataset
    the codec writes, and the codec reads what h5py writes."""
    from avlmaps_torch.map import hdf5

    data = {f"d{i:02d}": np.arange(i + 1, dtype=np.float32) * i
            for i in range(n)}
    if n:
        data["cs"] = np.asarray(0.05)
    hdf5.write(tmp_path / "ours.h5", data)
    with h5py.File(tmp_path / "ours.h5", "r") as f:
        assert sorted(f.keys()) == sorted(data)
        for k, v in data.items():
            np.testing.assert_array_equal(f[k][()], v)
    with h5py.File(tmp_path / "theirs.h5", "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    for path in ("ours.h5", "theirs.h5"):
        back = hdf5.read(tmp_path / path)
        assert sorted(back) == sorted(data)
        for k, v in data.items():
            np.testing.assert_array_equal(back[k], v)
