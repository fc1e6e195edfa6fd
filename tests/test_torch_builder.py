"""The port's map build as a whole (avlmaps_torch/map/vlmap_builder.py)
against the JAX package's VLMapBuilder on one synthetic scene.

Both builds read the same frames with the same tiny16 weights (converted
by params_from_flax) and the same seed, so the host draws the same pixel
samples: the occupied voxel set, the slot order and grid_pos must be
identical, and the fused features agree to f32 summation order.
"""

import dataclasses
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config
from avlmaps_tpu.geometry.projection import get_sim_cam_mat
from avlmaps_tpu.geometry.transforms import (build_base2cam_tf,
                                             build_base_transform)
from avlmaps_tpu.map import voxel_map as jax_voxel_map
from avlmaps_tpu.map.vlmap_builder import VLMapBuilder as JaxBuilder
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_tpu.pipeline.packed import pack_scene
from avlmaps_torch.map import vlmap_builder as tvb
from avlmaps_torch.map import voxel_map as torch_voxel_map
from avlmaps_torch.models.lseg import LSegConfig, LSegNet, params_from_flax
from tools.recall_parity import write_synthetic_scene

H = W = 32
N_FRAMES = 6


def _map_config(lseg_eval="sliding"):
    mc = load_config().map_config
    mc.lseg_eval = lseg_eval
    mc.grid_size = 64
    mc.cell_size = 0.1
    mc.pose_info.camera_height = 0.8
    mc.capacity = 16384
    mc.depth_sample_rate = 4
    mc.max_pts_per_frame = 256
    mc.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
    mc.lseg_base_size = W
    mc.lseg_crop_size = W
    return mc


def _frames(scene, n=N_FRAMES):
    return (sorted((scene / "rgb").glob("*.png"))[:n],
            sorted((scene / "depth").glob("*.npy"))[:n])


def _transforms(mc):
    pi = mc.pose_info
    return (build_base2cam_tf(pi.base2cam_rot, pi.camera_height),
            build_base_transform(pi.base_forward_axis, pi.base_left_axis,
                                 pi.base_up_axis))


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLSegNet(JaxLSegConfig.tiny16())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, H, W, 3), jnp.float32))
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    tnet.load_state_dict(params_from_flax(variables), strict=True)
    return jnet, variables, tnet


def _torch_builder(scene, tnet, half, n=N_FRAMES, lseg_eval="sliding",
                   **kw):
    mc = _map_config(lseg_eval)
    apply = (lambda x: tnet(x, upsample=False)) if half else tnet
    return tvb.VLMapBuilder(scene, mc, scene / "poses.txt", *_frames(scene, n),
                            *_transforms(mc), lseg_apply=apply, feat_dim=24,
                            batch_size=2, seed=0, half_res_apply=half,
                            device="cpu", **kw)


@pytest.fixture(scope="module", params=["full", "half", "whole"])
def builds(request, tmp_path_factory, nets):
    """The same scene built by both packages.  ``half`` selects the
    upsample=False LSeg with the half-resolution point sampler (the
    map-building main path); ``whole`` runs it over the padded canvas in
    one forward per frame (lseg_eval="whole") instead of the crop grid."""
    half = request.param != "full"
    lseg_eval = "whole" if request.param == "whole" else "sliding"
    jnet, variables, tnet = nets
    root = tmp_path_factory.mktemp(f"build_{request.param}")
    jscene = write_synthetic_scene(root / "jax", n_frames=N_FRAMES, h=H,
                                   w=W)
    tscene = root / "torch"
    shutil.copytree(jscene, tscene)
    mc = _map_config(lseg_eval)
    japply = (lambda p, x: jnet.apply(p, x, upsample=False)) if half \
        else jnet.apply
    jmap = JaxBuilder(jscene, mc, jscene / "poses.txt", *_frames(jscene),
                      *_transforms(mc), lseg_apply=japply,
                      lseg_params=variables, feat_dim=24, batch_size=2,
                      seed=0, half_res_apply=half).create_mobile_base_map(
        save_every=0, progress=False)
    builder = _torch_builder(tscene, tnet, half, lseg_eval=lseg_eval)
    tmap = builder.create_mobile_base_map(save_every=0, progress=False)
    return jmap, tmap, jscene, tscene, builder


def test_build_matches_jax(builds):
    jmap, tmap, _, _, builder = builds
    assert tmap.num_occupied > 0
    assert tmap.mapped_iters == jmap.mapped_iters == set(range(N_FRAMES))
    np.testing.assert_array_equal(tmap.grid_pos, jmap.grid_pos)
    np.testing.assert_array_equal(tmap.occupied_ids, jmap.occupied_ids)
    # identical points and weights; f32 sums in another order
    np.testing.assert_allclose(tmap.grid_feat, jmap.grid_feat, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tmap.weight, jmap.weight, rtol=1e-5,
                               atol=1e-6)
    # colour truncates to uint8 after the division
    assert np.abs(tmap.grid_rgb.astype(int) - jmap.grid_rgb).max() <= 1
    assert builder.build_stats["frames"] == N_FRAMES
    assert builder.build_stats["voxels"] == tmap.num_occupied


def _assert_same_map(a, b):
    for key in ("grid_feat", "grid_pos", "weight", "occupied_ids",
                "grid_rgb"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert a.mapped_iters == b.mapped_iters


@pytest.mark.parametrize("writer", ["h5py", "built-in"])
def test_each_package_reads_the_others_hdf5(builds, writer):
    """``h5py``: the JAX package's file (written by h5py) loads into the
    port.  ``built-in``: the port's file (its own codec, map/hdf5.py) loads
    into the JAX package, into the port, and dataset by dataset into h5py."""
    jmap, tmap, jscene, tscene, _ = builds
    if writer == "h5py":
        path = jscene / "vlmap" / "vlmaps.h5df"
        _assert_same_map(torch_voxel_map.SparseVoxelMap.load(path), jmap)
        return
    path = tscene / "vlmap" / "vlmaps.h5df"
    _assert_same_map(jax_voxel_map.SparseVoxelMap.load(path), tmap)
    _assert_same_map(torch_voxel_map.SparseVoxelMap.load(path), tmap)
    with h5py.File(str(path), "r") as f:
        np.testing.assert_array_equal(f["grid_feat"][()], tmap.grid_feat)
        np.testing.assert_array_equal(f["occupied_ids"][()],
                                      tmap.occupied_ids)
        np.testing.assert_array_equal(f["mapped_iter_list"][()],
                                      sorted(tmap.mapped_iters))


def test_resume_matches_uninterrupted(tmp_path, nets, monkeypatch):
    """Build 4 frames and save; a new builder over all 6 resumes from the
    file and fuses only frames 4-5.  With a history-free pixel sampler the
    result equals one uninterrupted 6-frame build, up to the export's
    rounding of the saved means."""
    _, _, tnet = nets

    def every_third_pixel(rng, h, w, rate, max_pts, batch):
        idx = np.arange(0, h * w, 3, dtype=np.int32)[:max_pts]
        return np.tile(idx, (batch, 1))

    monkeypatch.setattr(tvb, "sample_pixels", every_third_pixel)
    full_scene = write_synthetic_scene(tmp_path / "full", n_frames=N_FRAMES,
                                       h=H, w=W)
    part_scene = tmp_path / "part"
    shutil.copytree(full_scene, part_scene)
    full = _torch_builder(full_scene, tnet, True).create_mobile_base_map(
        save_every=0, progress=False)
    first = _torch_builder(part_scene, tnet, True, n=4)
    assert first.create_mobile_base_map(save_every=0, progress=False
                                        ).mapped_iters == set(range(4))
    resumed = _torch_builder(part_scene, tnet, True)
    part = resumed.create_mobile_base_map(save_every=0, progress=False)
    assert resumed.build_stats["frames"] == 2
    assert part.mapped_iters == full.mapped_iters == set(range(N_FRAMES))
    np.testing.assert_array_equal(part.grid_pos, full.grid_pos)
    np.testing.assert_allclose(part.grid_feat, full.grid_feat, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(part.weight, full.weight, rtol=1e-5)

    # everything mapped: nothing to fuse, the same map again
    again = _torch_builder(part_scene, tnet, True).create_mobile_base_map(
        save_every=0, progress=False)
    np.testing.assert_array_equal(again.grid_pos, part.grid_pos)
    np.testing.assert_array_equal(again.weight, part.weight)


@pytest.mark.parametrize("canvas", [False, True], ids=["frames", "canvas"])
def test_packed_scene_builds_like_jax(tmp_path, nets, canvas):
    """A scene packed by the JAX package's pack_scene -- decoded frames,
    with or without the stored LSeg canvas -- builds to the same map in
    both packages, and the port reads it from the pack."""
    jnet, variables, tnet = nets
    n = 4
    jscene = write_synthetic_scene(tmp_path / "jax", n_frames=n, h=H, w=W)
    pack_scene(*_frames(jscene, n), jscene / "scene.avpack",
               canvas_hw=(H, W) if canvas else None)
    tscene = tmp_path / "torch"
    shutil.copytree(jscene, tscene)  # copy2 keeps the pack newer
    mc = _map_config()
    jmap = JaxBuilder(jscene, mc, jscene / "poses.txt", *_frames(jscene, n),
                      *_transforms(mc),
                      lseg_apply=lambda p, x: jnet.apply(p, x,
                                                         upsample=False),
                      lseg_params=variables, feat_dim=24, batch_size=2,
                      seed=0, half_res_apply=True).create_mobile_base_map(
        save_every=0, progress=False)
    builder = _torch_builder(tscene, tnet, True, n=n)
    assert builder._packed_scene() is not None
    tmap = builder.create_mobile_base_map(save_every=0, progress=False)
    assert tmap.num_occupied > 0
    np.testing.assert_array_equal(tmap.grid_pos, jmap.grid_pos)
    # identical points and weights; f32 sums in another order
    np.testing.assert_allclose(tmap.grid_feat, jmap.grid_feat, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kwargs", [dict(transport="bogus"),
                                    dict(sampling="bogus"),
                                    dict(mesh=2)])
def test_unported_options_raise(tmp_path, nets, kwargs):
    """Unknown transports and samplers are refused; the multi-device
    build (``mesh``, here two CPU shards) runs and equals the
    single-device build's voxels (tests/test_torch_parallel.py holds it
    to the JAX package's)."""
    scene = write_synthetic_scene(tmp_path / "s", n_frames=2, h=H, w=W)
    if "mesh" not in kwargs:
        with pytest.raises(ValueError):
            _torch_builder(scene, nets[2], False, n=1, **kwargs)
        return
    from avlmaps_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * kwargs["mesh"])
    m = _torch_builder(scene, nets[2], False, n=2, mesh=mesh
                       ).create_mobile_base_map(save_every=0, progress=False)
    shutil.rmtree(scene / "vlmap")
    one = _torch_builder(scene, nets[2], False, n=2
                         ).create_mobile_base_map(save_every=0,
                                                  progress=False)
    assert m.num_occupied > 0 and m.mapped_iters == {0, 1}
    np.testing.assert_array_equal(m.occupied_ids >= 0, one.occupied_ids >= 0)


# ------------------------------------------------ the other transports --

# a 33x33 scene on a 17x17 canvas: the align-corners scale is exactly 0.5,
# so every odd pixel coordinate reads its colour at a .5 canvas position
# (half to even in both packages)
H33 = 33


def _map_config_33(lseg_eval="whole"):
    mc = _map_config(lseg_eval)
    mc.cam_calib_mat = tuple(get_sim_cam_mat(H33, H33).reshape(-1))
    mc.lseg_base_size = 17
    mc.lseg_crop_size = 32
    return mc


def _both_builds(tmp_path, nets, mc, n, pack=None, **kw):
    """The same scene built by both packages with the same options;
    ``pack``: None, or the ``canvas_hw`` of a scene.avpack written by the
    JAX package before the copy (``()`` for a pack without a canvas)."""
    jnet, variables, tnet = nets
    h = w = H33 if mc.lseg_base_size == 17 else H
    jscene = write_synthetic_scene(tmp_path / "jax", n_frames=n, h=h, w=w)
    if pack is not None:
        pack_scene(*_frames(jscene, n), jscene / "scene.avpack",
                   canvas_hw=pack or None)
    tscene = tmp_path / "torch"
    shutil.copytree(jscene, tscene)
    jmap = JaxBuilder(jscene, mc, jscene / "poses.txt", *_frames(jscene, n),
                      *_transforms(mc),
                      lseg_apply=lambda p, x: jnet.apply(p, x,
                                                         upsample=False),
                      lseg_params=variables, feat_dim=24, batch_size=2,
                      seed=3, half_res_apply=True, **kw
                      ).create_mobile_base_map(save_every=0, progress=False)
    builder = tvb.VLMapBuilder(
        tscene, mc, tscene / "poses.txt", *_frames(tscene, n),
        *_transforms(mc), lseg_apply=lambda x: tnet(x, upsample=False),
        feat_dim=24, batch_size=2, seed=3, half_res_apply=True,
        device="cpu", **kw)
    tmap = builder.create_mobile_base_map(save_every=0, progress=False)
    return jmap, tmap, builder


def _assert_maps_match(jmap, tmap, n):
    assert tmap.num_occupied > 0
    assert tmap.mapped_iters == jmap.mapped_iters == set(range(n))
    np.testing.assert_array_equal(tmap.grid_pos, jmap.grid_pos)
    np.testing.assert_array_equal(tmap.occupied_ids, jmap.occupied_ids)
    np.testing.assert_allclose(tmap.grid_feat, jmap.grid_feat, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tmap.weight, jmap.weight, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(tmap.grid_rgb.astype(int) - jmap.grid_rgb).max() <= 1


def test_device_sample_indices_match_jax_threefry():
    """The device sampler's draws are JAX's threefry bits, exactly: the
    test geometry and the 720x1080 one (a span past 2**16, where JAX's
    uint32 multiplier wraps), padding frame id -1 included."""
    fids = np.array([0, 3, 17, 63, -1], np.int32)
    for seed, n, span in ((3, 256, H33 * H33), (0, 7776, 720 * 1080)):
        key = jax.random.PRNGKey(seed)
        want = np.sort(np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, f), (n,), 0, span, dtype=jnp.int32))
            for f in fids]), axis=1)
        got = tvb.device_sample_indices(torch.from_numpy(fids), seed=seed,
                                        max_pts=n, n_pixels=span)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pack", [None, (17, 17)], ids=["png", "pack"])
def test_device_sampled_build_matches_jax(tmp_path, nets, pack):
    """sampling='device' (whole-canvas eval): the same draws, so the same
    voxels, slots and weights as the JAX package's build, from PNG/npy
    frames (the raw canvas transform) or from a pack's stored canvas."""
    mc = _map_config_33()
    jmap, tmap, builder = _both_builds(tmp_path, nets, mc, 4, pack=pack,
                                       sampling="device")
    assert (builder._packed_scene() is not None) == (pack is not None)
    _assert_maps_match(jmap, tmap, 4)
    # colours come from the canvas: whole bytes, sums of the same values
    assert builder.build_stats["frames"] == 4


def test_device_sampled_colour_rounds_half_to_even():
    """rint(x * 0.5) at x = 1, 3, 5: 0, 2, 2 -- torch.round as jnp.rint."""
    x = torch.tensor([1, 3, 5, 7], dtype=torch.float32) * 0.5
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.rint(jnp.asarray(
                                      x.numpy()))))
    np.testing.assert_array_equal(torch.round(x).numpy(), [0, 2, 2, 4])


@pytest.mark.parametrize("pack", [None, ()], ids=["png", "pack"])
def test_frame_transport_build_matches_jax(tmp_path, nets, pack):
    """transport='frame': full frames resized on the device, the same host
    draws as the JAX package, so the same map; from PNG/npy (f32 depth) or
    from a pack (uint16 depth rescaled on the device)."""
    jmap, tmap, _ = _both_builds(tmp_path, nets, _map_config(), 4,
                                 pack=pack, transport="frame")
    _assert_maps_match(jmap, tmap, 4)


def test_frame_transport_with_device_sampling_warns(tmp_path, nets):
    scene = write_synthetic_scene(tmp_path / "s", n_frames=2, h=H, w=W)
    b = _torch_builder(scene, nets[2], True, n=2, transport="frame",
                       sampling="device")
    with pytest.warns(UserWarning, match="needs transport='canvas'"):
        b.create_mobile_base_map(save_every=0, progress=False)


# ------------------------------------------------------------ the packs --

@pytest.mark.parametrize("depth_dtype", ["u16mm", "f32"])
@pytest.mark.parametrize("canvas_hw", [None, (17, 24)])
def test_pack_scene_writes_the_jax_packages_bytes(tmp_path, canvas_hw,
                                                  depth_dtype):
    from avlmaps_torch.pipeline.packed import pack_scene as torch_pack

    scene = write_synthetic_scene(tmp_path / "s", n_frames=3, h=H, w=W)
    want = pack_scene(*_frames(scene, 3), tmp_path / "jax.avpack",
                      canvas_hw=canvas_hw, depth_dtype=depth_dtype)
    seen = []
    got = torch_pack(*_frames(scene, 3), tmp_path / "torch.avpack",
                     canvas_hw=canvas_hw, depth_dtype=depth_dtype,
                     progress=lambda i, n: seen.append((i, n)))
    assert seen == [(1, 3), (2, 3), (3, 3)]
    assert got.read_bytes() == want.read_bytes()


def test_pack_scene_refuses_bad_input(tmp_path):
    from avlmaps_torch.pipeline.packed import pack_scene as torch_pack

    scene = write_synthetic_scene(tmp_path / "s", n_frames=2, h=H, w=W)
    rgb, depth = _frames(scene, 2)
    with pytest.raises(ValueError):
        torch_pack(rgb, depth[:1], tmp_path / "a.avpack")
    with pytest.raises(ValueError):
        torch_pack(rgb, depth, tmp_path / "b.avpack", depth_dtype="f16")
    with pytest.raises(ValueError):
        torch_pack([], [], tmp_path / "c.avpack")


@pytest.mark.parametrize("mode", ["raw_canvas", "frames_u16", "frames_m"])
def test_packed_loader_batches_equal_jax(tmp_path, mode):
    """PackedLoader's raw-canvas batches (stored canvas + full-res uint16
    depth) and frame batches (stored depth, or metres) equal the JAX
    package's, padding of the last batch included."""
    from avlmaps_tpu.pipeline.packed import PackedLoader as JaxLoader
    from avlmaps_tpu.pipeline.packed import PackedScene as JaxScene
    from avlmaps_torch.pipeline.packed import PackedLoader, PackedScene

    scene = write_synthetic_scene(tmp_path / "s", n_frames=5, h=H, w=W)
    path = pack_scene(*_frames(scene, 5), tmp_path / "scene.avpack",
                      canvas_hw=(17, 24))
    poses = [np.eye(4) * (i + 1) for i in range(5)]
    kw = dict(raw_canvas=mode == "raw_canvas",
              depth_metres=mode == "frames_m")
    want = list(JaxLoader(JaxScene(path), poses, batch_size=2, **kw))
    got = list(PackedLoader(PackedScene(path), poses, batch_size=2, **kw))
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        assert type(g).__name__ == type(w_).__name__
        for f in dataclasses.fields(w_):
            a, b = getattr(g, f.name), getattr(w_, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b)


def test_raw_canvas_transform_matches_jax(rng):
    """The device-sampling transport of PNG/npy frames: the canvas resize
    and the uint16-mm depth plane, equal to the JAX package's."""
    from avlmaps_tpu.pipeline.loader import FrameBatch as JaxFrameBatch
    from avlmaps_tpu.pipeline.transport import \
        make_raw_canvas_transform as jax_raw
    from avlmaps_torch.pipeline.loader import FrameBatch
    from avlmaps_torch.pipeline.transport import make_raw_canvas_transform

    rgb = rng.integers(0, 255, (2, H, W, 3)).astype(np.uint8)
    depth = rng.uniform(0.3, 70.0, (2, H, W)).astype(np.float32)
    fields = dict(frame_ids=np.array([0, -1], np.int32), rgb=rgb,
                  depth=depth, pose_tf=np.tile(np.eye(4, dtype=np.float32),
                                               (2, 1, 1)))
    want = jax_raw((17, 24))(JaxFrameBatch(**fields))
    got = make_raw_canvas_transform((17, 24))(FrameBatch(**fields))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.depth_mm.max() == 65535  # 70 m clips


def test_uint16_payloads_cross_as_their_bits(rng):
    """batch_to_device ships uint16 as int16 bits and widens them on the
    device: every value up to 65535 arrives unchanged as int32."""
    from avlmaps_torch.pipeline.loader import batch_to_device
    from avlmaps_torch.pipeline.transport import RawCanvasBatch

    depth = np.array([[[0, 1, 32767], [32768, 40000, 65535]]], np.uint16)
    batch = RawCanvasBatch(frame_ids=np.array([3], np.int32),
                           canvas=np.zeros((1, 2, 2, 3), np.uint8),
                           depth_mm=depth, pose_tf=np.eye(4)[None])
    moved = batch_to_device(batch, torch.device("cpu"))
    assert moved.depth_mm.dtype == torch.int32
    np.testing.assert_array_equal(moved.depth_mm.numpy(), depth)
    assert isinstance(moved.frame_ids, np.ndarray)
    assert moved.canvas.dtype == torch.uint8
