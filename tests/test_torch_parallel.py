"""The port's row-sharded build (avlmaps_torch/parallel) against the JAX
package's on the same seeded inputs.

The port's mesh is ``make_mesh(devices=["cpu"] * 4)``: four virtual
shards in this process.  The JAX package's is ``make_mesh(4)`` over the
virtual CPU devices of tests/conftest.py.  Both run the tiny16 LSeg with
the same weights (params_from_flax).  Each package allocates slots per
shard in the same order (one stable sort), so the exports agree slot for
slot: positions and occupied tables equal, weights within rtol 1e-5,
features within 1e-4 on the f32 wire (the two tiny16 forwards differ by
~1e-5) and 2e-2 on the bf16 wire (a feature near a bf16 rounding edge
may round the other way).  Each JAX ShardedFusion compiles its program
once; the module fixtures reuse it with a fresh state.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map import vlmap_builder as jvb
from avlmaps_tpu.map import vlmap_builder_multi_floor as jmf
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_tpu.ops.similarity import score_argmax as jax_score_argmax
from avlmaps_tpu.parallel import sharded as jsh
from avlmaps_torch.config import load_config
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.map import vlmap_builder as tvb
from avlmaps_torch.map import vlmap_builder_multi_floor as tmf
from avlmaps_torch.map.vlmap_builder import make_frame_step, sample_pixels
from avlmaps_torch.models.lseg import LSegConfig, LSegNet, params_from_flax
from avlmaps_torch.ops.voxel_fusion import (export_fusion_state,
                                            init_fusion_state)
from avlmaps_torch.parallel import sharded as tsh
from avlmaps_torch.parallel.dryrun import dryrun_multichip
from tests.test_multi_floor import write_scene as write_two_floor_scene
from tests.test_torch_builder import _map_config, _transforms
from tools.recall_parity import write_synthetic_scene

N_DEV = 4
H = W = 32
GS, CS, VH, D = 64, 0.1, 8, 24
CAP = 8192 * N_DEV
B, N_PTS = 2 * N_DEV, 64


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLSegNet(JaxLSegConfig.tiny16())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, H, W, 3), jnp.float32))
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    tnet.load_state_dict(params_from_flax(variables), strict=True)
    tnet.eval().requires_grad_(False)
    return jnet, variables, tnet


def _common():
    return dict(gs=GS, cs=CS, vh=VH, feat_dim=D, capacity=CAP,
                calib_mat=get_sim_cam_mat(H, W), image_hw=(H, W),
                base_size=W, crop_size=W)


class JaxFusion:
    """One JAX ShardedFusion, compiled once, stepped from a fresh state."""

    def __init__(self, nets, **kw):
        jnet, self.variables, _ = nets
        self.f = jsh.ShardedFusion(jsh.make_mesh(N_DEV), **_common(),
                                   lseg_apply=jnet.apply, **kw)

    def build(self, *batches, restore=None):
        self.f.state = self.f._init_state()
        if restore is not None:
            self.f.restore(*restore)
        for b in batches:
            self.f.step(self.variables, *(jnp.asarray(a) for a in b))
        return self.f.export(), np.asarray(self.f.state.n_dropped)


def torch_fusion(nets, **kw):
    return tsh.ShardedFusion(tsh.make_mesh(devices=["cpu"] * N_DEV),
                             **_common(), lseg_apply=nets[2], **kw)


def torch_build(nets, *batches, restore=None, **kw):
    f = torch_fusion(nets, **kw)
    if restore is not None:
        f.restore(*restore)
    with torch.no_grad():
        for b in batches:
            f.step(*b)
    dropped = np.array([int(st.n_dropped) for st in f.states])
    return f.export(), dropped, f


def frame_batch(seed, spread=True, u16=False):
    """(rgb, depth, pose, sample_idx, valid) host arrays; ``spread`` moves
    the frames along x so their points land in several shards' rows."""
    r = np.random.default_rng(seed)
    rgb = r.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    if u16:
        depth = r.integers(300, 1200, (B, H, W)).astype(np.uint16)
    else:
        depth = r.uniform(0.3, 1.2, (B, H, W)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    if spread:
        pose[:, 0, 3] = 0.4 * np.arange(B) - 1.6
    idx = sample_pixels(r, H, W, 16, N_PTS, B)
    return rgb, depth, pose, idx, np.ones((B,), bool)


def canvas_batch(seed):
    r = np.random.default_rng(seed)
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, 0, 3] = 0.4 * np.arange(B) - 1.6
    return (r.integers(0, 255, (B, H, W, 3)).astype(np.uint8),
            (r.uniform(0.3, 1.2, (B, N_PTS)) * 1000.0).astype(np.uint16),
            r.integers(0, 255, (B, N_PTS, 3)).astype(np.uint8), pose,
            sample_pixels(r, H, W, 16, N_PTS, B), np.ones((B,), bool))


def assert_maps(got, want, feat_tol, rgb_tol=1):
    fg, pg, wg, og, rg = got
    fw, pw, ww, ow, rw = want
    assert pg.shape[0] > 0
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_array_equal(og, ow)
    np.testing.assert_allclose(wg, ww, rtol=1e-5)
    np.testing.assert_allclose(fg, fw, rtol=feat_tol, atol=feat_tol)
    # colour truncates to uint8 after the division
    assert np.abs(rg.astype(int) - rw.astype(int)).max() <= rgb_tol


@pytest.fixture(scope="module")
def jax_f32(nets):
    return JaxFusion(nets, payload_dtype=jnp.float32)


def test_f32_wire_matches_jax_and_the_single_device_build(nets, jax_f32):
    batch = frame_batch(1)
    want, jdrop = jax_f32.build(batch)
    got, tdrop, f = torch_build(nets, batch, payload_dtype=torch.float32)
    assert_maps(got, want, 1e-4)
    assert (jdrop == 0).all() and (tdrop == 0).all()
    assert sum(int(st.n_slots) > 0 for st in f.states) >= 2
    # the port's single-device step fuses the same voxels
    step = make_frame_step(nets[2], **{k: v for k, v in _common().items()
                                       if k not in ("feat_dim", "capacity")},
                           device="cpu")
    state = init_fusion_state(GS, VH, D, CAP, device="cpu")
    with torch.no_grad():
        state = step(state, *(torch.from_numpy(a) for a in batch))
    f1, p1, w1, o1, _ = export_fusion_state(state, GS, VH)
    np.testing.assert_array_equal(o1 >= 0, got[3] >= 0)
    k1, k2 = np.lexsort(p1.T), np.lexsort(got[1].T)
    np.testing.assert_array_equal(p1[k1], got[1][k2])
    np.testing.assert_allclose(w1[k1], got[2][k2], rtol=1e-5)
    np.testing.assert_allclose(f1[k1], got[0][k2], rtol=1e-5, atol=1e-5)


def test_bf16_wire_matches_jax(nets):
    batch = frame_batch(2)
    want, _ = JaxFusion(nets).build(batch)
    got, _, _ = torch_build(nets, batch)
    assert_maps(got, want, 2e-2)
    # the wire rounds: the f32-wire build differs, within bf16's rounding
    f32, _, _ = torch_build(nets, batch, payload_dtype=torch.float32)
    assert not np.array_equal(got[0], f32[0])
    np.testing.assert_allclose(got[0], f32[0], rtol=2e-2, atol=2e-2)


def test_all_to_all_routing(nets):
    """A lossless bucket (slack = n) builds the all-gather map bit for
    bit; at slack 1 on a skewed batch both packages drop the same points
    on the same sending shards and keep the same map."""
    batch = frame_batch(3)
    gather, _, _ = torch_build(nets, batch, payload_dtype=torch.float32)
    a2a, drop, _ = torch_build(nets, batch, payload_dtype=torch.float32,
                               payload_routing="all_to_all",
                               a2a_slack=float(N_DEV))
    assert (drop == 0).all()
    for g, a in zip(gather, a2a):
        np.testing.assert_array_equal(g, a)

    skewed = frame_batch(4, spread=False)
    want, jdrop = JaxFusion(nets, payload_dtype=jnp.float32,
                            payload_routing="all_to_all",
                            a2a_slack=1.0).build(skewed)
    got, tdrop, _ = torch_build(nets, skewed, payload_dtype=torch.float32,
                                payload_routing="all_to_all", a2a_slack=1.0)
    assert jdrop.sum() > 0
    np.testing.assert_array_equal(tdrop, jdrop)
    assert_maps(got, want, 1e-4)
    # a drop only removes mass: every voxel is in the lossless build
    lossless, _, _ = torch_build(nets, skewed, payload_dtype=torch.float32)
    assert not np.any((got[3] >= 0) & ~(lossless[3] >= 0))


def test_uint16_depth_matches_jax(nets, jax_f32):
    batch = frame_batch(5, u16=True)
    want, _ = jax_f32.build(batch)
    got, _, _ = torch_build(nets, batch, payload_dtype=torch.float32)
    assert_maps(got, want, 1e-4)
    metres = list(batch)
    metres[1] = batch[1].astype(np.float32) * 1e-3
    as_m, _, _ = torch_build(nets, metres, payload_dtype=torch.float32)
    for g, m in zip(got, as_m):
        np.testing.assert_array_equal(g, m)


@pytest.mark.parametrize("lseg_eval", ["sliding", "whole"])
def test_canvas_transport_matches_jax(nets, lseg_eval):
    batch = canvas_batch(6)
    want, _ = JaxFusion(nets, payload_dtype=jnp.float32, transport="canvas",
                        lseg_eval=lseg_eval).build(batch)
    got, _, _ = torch_build(nets, batch, payload_dtype=torch.float32,
                            transport="canvas", lseg_eval=lseg_eval)
    assert_maps(got, want, 1e-4)


def test_options_are_checked(nets):
    with pytest.raises(ValueError, match="canvas"):
        torch_fusion(nets, lseg_eval="whole")
    with pytest.raises(ValueError, match="payload_routing"):
        torch_fusion(nets, payload_routing="ring")
    with pytest.raises(ValueError, match="3 callables for 4 shards"):
        tsh.ShardedFusion(tsh.make_mesh(devices=["cpu"] * N_DEV),
                          **_common(), lseg_apply=[nets[2]] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.ShardedFusion(tsh.make_mesh(devices=["cpu"] * 3), **_common(),
                          lseg_apply=nets[2])
    f = torch_fusion(nets)
    with pytest.raises(ValueError, match="multiple of the 4-device mesh"):
        f.step(*(a[:6] for a in frame_batch(0)))


def test_lseg_apply_one_per_mesh_entry(nets):
    """A sequence of networks, one per shard, builds what one shared
    network builds."""
    batch = frame_batch(13)
    shared, _, _ = torch_build(nets, batch)
    f = tsh.ShardedFusion(tsh.make_mesh(devices=["cpu"] * N_DEV),
                          **_common(), lseg_apply=[nets[2]] * N_DEV)
    with torch.no_grad():
        f.step(*batch)
    for a, b in zip(f.export(), shared):
        np.testing.assert_array_equal(a, b)


def test_restore_sharded_matches_jax(nets):
    saved, _, _ = torch_build(nets, frame_batch(7))
    # a stale occupied entry must not leak into any shard
    saved = list(saved)
    saved[3] = saved[3].copy()
    saved[3][0, 0, 0] = 5
    kw = dict(n_dev=N_DEV, gs=GS, vh=VH, rows_per_dev=GS // N_DEV,
              cap_per_dev=CAP // N_DEV, feat_dim=D)
    want = jsh.restore_sharded(*saved, **kw)
    got = tsh.restore_sharded(*saved, **kw, devices=["cpu"] * N_DEV)
    for name in ("occupied_flat", "accum"):
        np.testing.assert_array_equal(
            torch.cat([getattr(st, name) for st in got]).numpy(),
            np.asarray(getattr(want, name)))
    for name in ("n_slots", "n_dropped"):
        np.testing.assert_array_equal(
            np.array([int(getattr(st, name)) for st in got]),
            np.asarray(getattr(want, name)))


def test_kill_and_resume_matches_uninterrupted(nets, jax_f32):
    a, b = frame_batch(10), frame_batch(11)
    full, _, _ = torch_build(nets, a, b)
    half, _, _ = torch_build(nets, a)
    resumed, _, _ = torch_build(nets, b, restore=half)
    assert_maps(resumed, full, 1e-3)
    # and the JAX package's resume of the same checkpoint
    want, _ = jax_f32.build(b, restore=half)
    got, _, _ = torch_build(nets, b, restore=half,
                            payload_dtype=torch.float32)
    assert_maps(got, want, 1e-4)


@pytest.fixture(scope="module")
def mesh_builds(tmp_path_factory, nets):
    """VLMapBuilder(mesh=) of both packages on copies of one 8-frame scene:
    the first 4 frames (batch 6 rounds down to 4, one frame a shard),
    then all 8 resumed from the saved map with a save every 4 frames."""
    jnet, variables, tnet = nets
    root = tmp_path_factory.mktemp("mesh_build")
    jscene = write_synthetic_scene(root / "jax", n_frames=8, h=H, w=W)
    tscene = root / "torch"
    shutil.copytree(jscene, tscene)
    mc = _map_config()

    def frames(scene, n):
        return (sorted((scene / "rgb").glob("*.png"))[:n],
                sorted((scene / "depth").glob("*.npy"))[:n])

    def jax_builder(n):
        return jvb.VLMapBuilder(
            jscene, mc, jscene / "poses.txt", *frames(jscene, n),
            *_transforms(mc), lseg_apply=jnet.apply, lseg_params=variables,
            feat_dim=D, batch_size=6, seed=0, mesh=jsh.make_mesh(N_DEV))

    def torch_builder(n):
        return tvb.VLMapBuilder(
            tscene, mc, tscene / "poses.txt", *frames(tscene, n),
            *_transforms(mc), lseg_apply=tnet, feat_dim=D, batch_size=6,
            seed=0, mesh=tsh.make_mesh(devices=["cpu"] * N_DEV))

    out = {}
    for name, make in (("jax", jax_builder), ("torch", torch_builder)):
        half = make(4).create_mobile_base_map(save_every=0, progress=False)
        b = make(8)
        full = b.create_mobile_base_map(save_every=4, progress=False)
        out[name] = (half, full, b)
    return out


def _map_arrays(m):
    return (m.grid_feat, m.grid_pos, m.weight, m.occupied_ids, m.grid_rgb)


def test_builder_mesh_matches_jax(mesh_builds):
    jhalf, _, _ = mesh_builds["jax"]
    thalf, _, _ = mesh_builds["torch"]
    assert thalf.mapped_iters == jhalf.mapped_iters == set(range(4))
    assert_maps(_map_arrays(thalf), _map_arrays(jhalf), 2e-2)


def test_builder_mesh_samples_on_the_host(tmp_path, nets):
    """sampling='device' warns on a mesh and draws on the host, as the
    JAX package does: the map equals the host-sampled mesh build's."""
    scene = write_synthetic_scene(tmp_path / "s", n_frames=4, h=H, w=W)
    mc = _map_config()
    maps = []
    for i, sampling in enumerate(("host", "device")):
        b = tvb.VLMapBuilder(
            scene, mc, scene / "poses.txt",
            sorted((scene / "rgb").glob("*.png")),
            sorted((scene / "depth").glob("*.npy")), *_transforms(mc),
            lseg_apply=nets[2], feat_dim=D, batch_size=4, seed=0,
            sampling=sampling, mesh=tsh.make_mesh(devices=["cpu"] * N_DEV))
        b.map_save_path = tmp_path / f"map{i}.h5df"
        if sampling == "device":
            with pytest.warns(UserWarning, match="host sampler"):
                maps.append(b.create_mobile_base_map(save_every=0,
                                                     progress=False))
        else:
            maps.append(b.create_mobile_base_map(save_every=0,
                                                 progress=False))
    assert maps[0].num_occupied > 0
    for a, b in zip(_map_arrays(maps[0]), _map_arrays(maps[1])):
        np.testing.assert_array_equal(a, b)


def test_builder_mesh_resumes_as_jax(mesh_builds):
    _, jfull, _ = mesh_builds["jax"]
    thalf, tfull, builder = mesh_builds["torch"]
    assert tfull.mapped_iters == jfull.mapped_iters == set(range(8))
    assert tfull.weight.sum() > thalf.weight.sum()
    assert_maps(_map_arrays(tfull), _map_arrays(jfull), 2e-2)
    assert builder.build_stats["frames"] == 4
    assert builder.build_stats["voxels"] == tfull.grid_feat.shape[0]


def test_multi_floor_mesh_matches_jax(tmp_path, nets):
    """The multi-floor build on 4 shards (gs padded to a multiple of 4,
    validity bounded by the probe) against the JAX package's, and
    ``index_map_sharded`` of both behind one fake CLIP."""
    jnet, variables, tnet = nets
    scene_j, pose_tfs = write_two_floor_scene(tmp_path / "jax", n_frames=8)
    scene_t, _ = write_two_floor_scene(tmp_path / "torch", n_frames=8)

    def configure(cfg):
        mc = cfg.map_config
        mc.cell_size = 0.1
        mc.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
        mc.capacity = 8192
        mc.depth_sample_rate = 16
        mc.max_pts_per_frame = 64
        mc.lseg_base_size = W
        mc.lseg_crop_size = W
        return mc

    def frames(scene):
        return (sorted((scene / "rgb").glob("*.png")),
                sorted((scene / "depth").glob("*.npy")))

    jb = jmf.VLMapBuilderMultiFloor(
        scene_j, configure(jax_load_config()), *frames(scene_j), pose_tfs,
        lseg_apply=jnet.apply, lseg_params=variables, feat_dim=D,
        batch_size=8, seed=3, mesh=jsh.make_mesh(N_DEV))
    tb = tmf.VLMapBuilderMultiFloor(
        scene_t, configure(load_config()), *frames(scene_t), pose_tfs,
        lseg_apply=tnet, feat_dim=D, batch_size=8, seed=3,
        mesh=tsh.make_mesh(devices=["cpu"] * N_DEV))
    want = jb.create_global_map(progress=False)
    got = tb.create_global_map(progress=False)
    gs_bound = tb.grid_dims()[0]
    assert got[3].shape[0] == -(-gs_bound // N_DEV) * N_DEV
    assert got[1][:, :2].max() < gs_bound
    assert_maps(got, want, 2e-2)

    class FakeClip:
        feat_dim = D

        def get_text_feats_multiple_templates(self, cats, batch_size=64):
            t = np.random.default_rng(1).normal(
                size=(len(cats), D)).astype(np.float32)
            return t / np.linalg.norm(t, axis=1, keepdims=True)

    jm = jmf.VLMapMultiFloor(configure(jax_load_config()))
    tm = tmf.VLMapMultiFloor(configure(load_config()), device="cpu")
    assert jm.load_map(scene_j) and tm.load_map(scene_t)
    jm.clip_encoder = tm.clip_encoder = FakeClip()
    jmask = jm.index_map_sharded(jsh.make_mesh(N_DEV), "chair")
    tmask = tm.index_map_sharded(tsh.make_mesh(devices=["cpu"] * N_DEV),
                                 "chair")
    np.testing.assert_array_equal(tmask, jmask)
    text = FakeClip().get_text_feats_multiple_templates(["chair", "other"])
    assert tmask.any()
    np.testing.assert_array_equal(
        tmask, (tm.grid_feat @ text.T).argmax(axis=1) == 0)


@pytest.mark.parametrize("row_offset", [0, 16, 48])
def test_point_geometry_row_ownership_matches_jax(row_offset):
    """make_point_geometry(n_rows, row_offset): shard-local ids of the
    rows a shard owns and the ownership mask, as the JAX package's."""
    kw = dict(gs=GS, cs=CS, vh=VH, calib_mat=get_sim_cam_mat(H, W),
              image_hw=(H, W), base_size=W, crop_size=W, min_depth=0.1,
              max_depth=6.0, n_rows=GS // N_DEV, row_offset=row_offset)
    jgeo, rows = jvb.make_point_geometry(**kw)
    tgeo = tvb.make_point_geometry(**kw, device="cpu")
    _, depth, pose, idx, _ = frame_batch(12)
    z = np.take_along_axis(depth.reshape(B, -1), idx, axis=1)
    want = jgeo(jnp.asarray(z), jnp.asarray(idx), jnp.asarray(pose))
    got = tgeo(torch.from_numpy(z), torch.from_numpy(idx),
               torch.from_numpy(pose))
    assert rows == GS // N_DEV
    for name, g, w in zip(("vids", "fx", "fy", "alpha", "valid"), got, want):
        if name == "alpha":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    valid = got[4].numpy()
    assert valid.any() and not valid.all()
    assert got[0].numpy()[valid].max() < rows * GS * VH


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_sharded_score_argmax_matches_jax(rng, n_dev):
    n, d, c = 4099, 64, 7  # not a multiple of n_dev * 8
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats[100:140] = 0.0  # tie rows must agree across paths too
    text = rng.normal(size=(c, d)).astype(np.float32)
    got = tsh.sharded_score_argmax(tsh.make_mesh(devices=["cpu"] * n_dev),
                                   feats, text)
    want = jsh.sharded_score_argmax(jsh.make_mesh(n_dev), feats, text)
    single = np.asarray(jax_score_argmax(jnp.asarray(feats),
                                         jnp.asarray(text),
                                         normalize_map=True,
                                         normalize_text=True))
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_dryrun_multichip_on_the_cpu():
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["shards"] == 4 and out["voxels"] > 0
