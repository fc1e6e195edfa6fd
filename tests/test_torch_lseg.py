"""The port's LSeg (avlmaps_torch/models/lseg), its geometry and resize
against the JAX package's twins, on the CPU in f32.

Network outputs are held to the golden 5e-3 of docs/PARITY.md §2.2; the
geometry and resize ports compute the same f32 arithmetic and are held
far tighter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.geometry import grid as jgrid
from avlmaps_tpu.geometry import projection as jproj
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_tpu.models.lseg import window as jwin
from avlmaps_tpu.models.lseg.model import cast_params_for_inference \
    as jax_cast
from avlmaps_tpu.ops import resize as jresize
from avlmaps_torch.geometry import grid as tgrid
from avlmaps_torch.geometry import projection as tproj
from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                       cast_params_for_inference,
                                       init_params, params_from_flax)
from avlmaps_torch.models.lseg import window as twin
from avlmaps_torch.ops import resize as tresize

SIZES = {"tiny": 32, "tiny16": 32, "medium": 192}


@functools.lru_cache(maxsize=None)
def _flax(name):
    """A flax LSeg with perturbed weights (non-trivial biases and LN
    scales) and its jitted apply, built once per config."""
    hw = SIZES[name]
    jnet = JaxLSegNet(getattr(JaxLSegConfig, name)())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, hw, hw, 3), jnp.float32))
    noise = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + noise.normal(size=a.shape).astype(
            np.float32) * 0.02, variables)
    return jax.jit(jnet.apply, static_argnames="upsample"), variables


def _pair(name):
    """(flax apply, flax variables, the port's LSeg with those weights)."""
    apply, variables = _flax(name)
    tnet = LSegNet(getattr(LSegConfig, name)(), device="cpu")
    tnet.load_state_dict(params_from_flax(variables), strict=True)
    return apply, variables, tnet


@pytest.mark.parametrize("name", ["tiny", "tiny16", "medium"])
def test_params_from_flax_loads_strictly(name):
    _, variables, tnet = _pair(name)
    sd = params_from_flax(variables)
    assert set(sd) == set(tnet.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(variables))
    assert sum(t.numel() for t in sd.values()) == n_flax


@pytest.mark.parametrize("upsample", [True, False])
@pytest.mark.parametrize("name", ["tiny", "tiny16", "medium"])
def test_forward_matches_flax(name, upsample):
    jnet, variables, tnet = _pair(name)
    hw = SIZES[name]
    x = np.random.default_rng(3).normal(size=(2, hw, hw, 3)).astype(
        np.float32)
    want = np.asarray(jnet(variables, jnp.asarray(x), upsample=upsample))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), upsample=upsample).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_forward_resized_posembed_matches_flax():
    """A 48x48 input resizes the tiny model's 4x4 pos-embed grid to 6x6."""
    jnet, variables, tnet = _pair("tiny")
    x = np.random.default_rng(4).normal(size=(1, 48, 48, 3)).astype(
        np.float32)
    want = np.asarray(jnet(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def _resample_launches(monkeypatch, net):
    """Counts the fourth reassemble stage's strided conv launches."""
    from avlmaps_torch.models.lseg import dpt

    calls, conv = [], dpt.conv

    def counted(x, m, dt):
        if m is net.decoder.reassemble[3].resample:
            calls.append(x.shape[0])
        return conv(x, m, dt)

    monkeypatch.setattr(dpt, "conv", counted)
    return calls


def test_per_image_strided_conv_forward_matches_flax(monkeypatch):
    """A batch of 6 crops takes the strided conv one image at a time and
    still matches the JAX forward at the golden 5e-3."""
    jnet, variables, tnet = _pair("tiny16")
    x = np.random.default_rng(5).normal(size=(6, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jnet(variables, jnp.asarray(x), upsample=False))
    calls = _resample_launches(monkeypatch, tnet)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), upsample=False).numpy()
    assert calls == [1] * 6
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


# bf16: bit for bit on the CPU; f32: the ViT's CPU matmuls block by the
# batch's rows, a few f32 ulps of the 1/0.07-scaled features (1.8e-5
# measured, under 1e-4)
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 0.0),
                                        (torch.float32, 1e-4)])
def test_forward_of_a_batch_equals_each_crops_own(monkeypatch, dtype, atol):
    net = LSegNet(LSegConfig.tiny16(dtype), device="cpu")
    net.load_state_dict(init_params(net.cfg, torch.Generator().manual_seed(0)),
                        strict=True)
    cast_params_for_inference(net)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 64, 64, 3)).astype(np.float32))
    calls = _resample_launches(monkeypatch, net)
    with torch.no_grad():
        whole = net(x, upsample=False).float()
        own = torch.cat([net(c, upsample=False) for c in x.split(1)]).float()
    assert calls == [1] * 12
    assert float((whole - own).abs().max()) <= atol


def test_bf16_model_emits_bf16_half_res():
    net = LSegNet(LSegConfig.tiny16(torch.bfloat16), device="cpu")
    net.load_state_dict(init_params(net.cfg, torch.Generator().manual_seed(0)),
                        strict=True)
    cast_params_for_inference(net)
    with torch.no_grad():
        out = net(torch.zeros(1, 32, 32, 3), upsample=False)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 16, 24)
    assert torch.isfinite(out.float()).all()


def test_cast_params_follows_the_jax_rule():
    """The same parameters become bf16 in both packages: matrices without
    a size-1 axis, outside the readout projections."""
    _, variables, tnet = _pair("tiny16")
    cast = jax_cast(variables)
    flat = jax.tree_util.tree_flatten_with_path(cast)[0]
    jax_bf16 = sum(int(np.asarray(leaf).dtype == jnp.bfloat16)
                   for _, leaf in flat)
    cast_params_for_inference(tnet)
    torch_bf16 = [n for n, p in tnet.named_parameters()
                  if p.dtype == torch.bfloat16]
    assert len(torch_bf16) == jax_bf16 > 0
    assert not any("readout" in n for n in torch_bf16)


def test_init_params_seeded():
    cfg = LSegConfig.tiny16()
    a = init_params(cfg, torch.Generator().manual_seed(5))
    b = init_params(cfg, torch.Generator().manual_seed(5))
    net = LSegNet(cfg, device="cpu")
    net.load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["backbone.blocks.0.norm1.weight"],
                       torch.ones(cfg.vit.width))


# ---------------------------------------------------------------- resize --

@pytest.mark.parametrize("shape", [(24, 24, 6, 6), (24, 24, 30, 30),
                                   (24, 24, 23, 34), (12, 16, 5, 7),
                                   (7, 7, 1, 1)])
def test_resizes_match_jax(shape):
    ih, iw, oh, ow = shape
    x = np.random.default_rng(0).normal(size=(2, ih, iw, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tresize.resize_bilinear(torch.from_numpy(x), oh, ow).numpy(),
        np.asarray(jresize.resize_bilinear(jnp.asarray(x), oh, ow)),
        atol=1e-6)
    want = np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), oh, ow))
    np.testing.assert_allclose(
        tresize.resize_bilinear_align_corners(torch.from_numpy(x), oh,
                                              ow).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        tresize.resize_bilinear_align_corners_nchw(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), oh,
            ow).numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


# -------------------------------------------------------------- geometry --

def test_projection_matches_jax(rng):
    depth = rng.uniform(0.05, 7.0, (12, 18)).astype(np.float32)
    inv = np.linalg.inv(jproj.get_sim_cam_mat(12, 18)).astype(np.float32)
    want_pc, want_mask = jproj.depth_to_pointcloud_jax(jnp.asarray(depth),
                                                       jnp.asarray(inv))
    got_pc, got_mask = tproj.depth_to_pointcloud(torch.from_numpy(depth),
                                                 torch.from_numpy(inv))
    np.testing.assert_allclose(got_pc.numpy(), np.asarray(want_pc),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    np.testing.assert_allclose(
        tproj.transform_points(got_pc, torch.from_numpy(pose)).numpy(),
        np.asarray(jproj.transform_points_jax(want_pc, jnp.asarray(pose))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tproj.get_sim_cam_mat(12, 18),
                                  jproj.get_sim_cam_mat(12, 18))


def test_fov_intrinsics_and_point_projection_match_jax(rng):
    """Host helpers: exact, including negative projections, where
    ``int(u - 0.5)`` truncates toward zero rather than flooring."""
    for h, w, fov in ((720, 1080, 90), (240, 320, 60.5), (7, 9, 120)):
        np.testing.assert_array_equal(
            tproj.get_sim_cam_mat_with_fov(h, w, fov),
            jproj.get_sim_cam_mat_with_fov(h, w, fov))
    cam = jproj.get_sim_cam_mat_with_fov(48, 64, 90)
    pts = np.concatenate([rng.uniform(-3, 3, (200, 2)),
                          rng.uniform(0.2, 4, (200, 1))], axis=1)
    pts[0] = [-0.99, 0.0, 1.0]  # u - 0.5 = -0.18: truncates to 0, not -1
    got, want = tproj.project_points(cam, pts), jproj.project_points(cam, pts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0][0] == 0 and (got[0] < 0).any()


def test_grid_ids_match_jax_including_double_truncation(rng):
    gs, cs, vh = 40, 0.1, 8
    pos = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    # x/cs = +-1.4 and z < 0: where the reference's scalar converter
    # (double truncation) and its batch converter disagree
    pos[:4] = [[0.14, -0.14, 0.2], [-0.14, 0.14, -0.05], [1.44, 0.0, 0.0],
               [-1.44, 0.0, 0.79]]
    want = np.asarray(jgrid.base_pos_to_grid_id_jax(gs, cs,
                                                    jnp.asarray(pos)))
    got = tgrid.base_pos_to_grid_id(gs, cs, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 19  # int(20 - int(1.4)), not int(20 - 1.4) == 18
    np.testing.assert_array_equal(
        tgrid.out_of_range_mask(got, gs, vh).numpy(),
        np.asarray(jgrid.out_of_range_mask_jax(jnp.asarray(want), gs, vh)))
    np.testing.assert_array_equal(
        tgrid.voxel_linear_id(got, gs, vh).numpy(),
        np.asarray(jgrid.voxel_linear_id_jax(jnp.asarray(want), gs, vh)))


# ---------------------------------------------------------------- window --

@pytest.mark.parametrize("hw", [(720, 1080), (480, 640), (100, 100)])
def test_plan_windows_matches_jax(hw):
    assert twin.plan_windows(*hw) == jwin.plan_windows(*hw)
    assert twin.plan_windows(*hw, base_size=96, crop_size=128) == \
        jwin.plan_windows(*hw, base_size=96, crop_size=128)


def test_window_features_match_jax():
    """Sliding-window canvas, its point gather and the half-res sampler on
    the tiny16 network, 48x48 frames, base 32 / crop 32 (several
    overlapping windows)."""
    jnet, variables, tnet = _pair("tiny16")
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    height, width, _, _, _ = jwin.plan_windows(48, 48, 32, 32)
    px = rng.integers(-2, width + 2, (2, 40)).astype(np.int32)
    py = rng.integers(-2, height + 2, (2, 40)).astype(np.int32)
    ji, tx = jnp.asarray(img), torch.from_numpy(img)

    with torch.no_grad():
        canvas = twin.sliding_window_features(tnet, tx, 32, 32)
        np.testing.assert_allclose(
            canvas.numpy(),
            np.asarray(jwin.sliding_window_features(jnet, variables, ji, 32,
                                                    32)),
            rtol=5e-3, atol=5e-3)
        for half in (False, True):
            if half:
                def japply(p, x):
                    return jnet(p, x, upsample=False)

                def tapply(x):
                    return tnet(x, upsample=False)
            else:
                japply, tapply = jnet, tnet
            want = jwin.features_at_points(japply, variables, ji,
                                           jnp.asarray(px), jnp.asarray(py),
                                           32, 32, half_res_apply=half)
            got = twin.features_at_points(tapply, tx, torch.from_numpy(px),
                                          torch.from_numpy(py), 32, 32,
                                          half_res_apply=half)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=5e-3, atol=5e-3)
        # whole-canvas mode: one forward over the 32-padded canvas
        want = jwin.whole_canvas_features_at_points(
            lambda p, x: jnet(p, x, upsample=False), variables, ji,
            jnp.asarray(px), jnp.asarray(py))
        got = twin.whole_canvas_features_at_points(
            lambda x: tnet(x, upsample=False), tx, torch.from_numpy(px),
            torch.from_numpy(py))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                                   atol=5e-3)


def test_window_features_flip_match_jax():
    """``flip=True``: the mirrored crops join the batch and their mirrored
    output is summed in, as in JAX (tiny16, 48x48 frames, base 32 / crop
    32, several overlapping windows)."""
    jnet, variables, tnet = _pair("tiny16")
    img = np.random.default_rng(6).normal(size=(2, 48, 48, 3)).astype(
        np.float32)
    ji, tx = jnp.asarray(img), torch.from_numpy(img)
    with torch.no_grad():
        got = twin.sliding_window_features(tnet, tx, 32, 32, flip=True)
        plain = twin.sliding_window_features(tnet, tx, 32, 32)
    want = np.asarray(jwin.sliding_window_features(jnet, variables, ji, 32,
                                                   32, flip=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
    # the mirrored pass is seen: the sum is not twice the unmirrored one
    assert np.abs(got.numpy() - 2 * plain.numpy()).max() > 0.1


@pytest.mark.parametrize("flip", [False, True])
def test_multi_scale_features_match_jax(flip):
    """``multi_scale_features`` at the six default scales on the tiny16
    network, 40x56 frames, base 32 / crop 32: scales 0.5-1.0 fit one
    padded crop, 1.25-1.75 run the overlapping grid (JAX's case:
    tests/test_lseg.py::TestMultiScaleFlip).  The golden 5e-3, on a sum
    of six scales."""
    jnet, variables, tnet = _pair("tiny16")
    img = np.random.default_rng(7).normal(size=(1, 40, 56, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = twin.multi_scale_features(tnet, torch.from_numpy(img), 32, 32,
                                        flip=flip)
    want = np.asarray(jwin.multi_scale_features(jnet, variables,
                                                jnp.asarray(img), 32, 32,
                                                flip=flip))
    assert twin.DEFAULT_SCALES == jwin.DEFAULT_SCALES
    assert got.shape == (1, 40, 56, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)


def test_bilinear_patch_sample_matches_jax(rng):
    fmap = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    sx = rng.uniform(0, 10, (2, 30)).astype(np.float32)
    sy = rng.uniform(0, 8, (2, 30)).astype(np.float32)
    sx[0, :2] = [0.0, 10.0]  # both edges
    sy[0, :2] = [8.0, 0.0]
    np.testing.assert_allclose(
        twin.bilinear_patch_sample(torch.from_numpy(fmap),
                                   torch.from_numpy(sx),
                                   torch.from_numpy(sy)).numpy(),
        np.asarray(jwin.bilinear_patch_sample(jnp.asarray(fmap),
                                              jnp.asarray(sx),
                                              jnp.asarray(sy))),
        rtol=1e-6, atol=1e-6)


def test_normalize_image_matches_jax(rng):
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(twin.normalize_image(img),
                                  jwin.normalize_image(img))


def test_lseg_checkpoint_loader_matches_jax_porter(tmp_path):
    """The reference-layout Lightning checkpoint of the repository's torch
    oracle goes through the port's loader to the same weights as through
    the JAX package's porter and the flax bridge, and runs the oracle's
    forward."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from avlmaps_tpu.models.lseg.port import \
        load_lseg_checkpoint as jax_load
    from avlmaps_torch.models.lseg.port import load_lseg_checkpoint
    from tools.torch_reference.lseg_torch import (
        TorchLSegSpec, build_torch_lseg, export_reference_state_dict)

    oracle = build_torch_lseg(TorchLSegSpec.tiny(), seed=0)
    sd = export_reference_state_dict(oracle)  # "net."-prefixed keys
    path = tmp_path / "demo.ckpt"
    torch.save({"state_dict": sd, "epoch": 200}, path)
    got = load_lseg_checkpoint(str(path))
    want = params_from_flax(jax_load(str(path)))
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    tnet = LSegNet(LSegConfig.tiny(), device="cpu")
    tnet.load_state_dict(got, strict=True)
    x = np.random.default_rng(5).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
        ref = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(out.transpose(0, 3, 1, 2), ref, rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------- ViT routes --

def _taps_pair(name, attn_impl):
    """The JAX backbone (non-jitted, so patched module flags are read) and
    the port's LSeg with the same weights, both with ``attn_impl``."""
    import dataclasses

    from avlmaps_tpu.models.lseg.vit import DenseViT as JaxDenseViT

    _, variables = _flax(name)
    jcfg = getattr(JaxLSegConfig, name)()
    jvit = JaxDenseViT(dataclasses.replace(jcfg.vit, attn_impl=attn_impl))
    tcfg = getattr(LSegConfig, name)()
    tcfg = dataclasses.replace(
        tcfg, vit=dataclasses.replace(tcfg.vit, attn_impl=attn_impl))
    tnet = LSegNet(tcfg, device="cpu")
    tnet.load_state_dict(params_from_flax(variables), strict=True)
    return (lambda x: jvit.apply({"params": variables["params"]["backbone"]},
                                 x)), tnet


def _assert_taps_match(name, japply, tnet):
    hw = SIZES[name]
    x = np.random.default_rng(6).normal(size=(2, hw, hw, 3)).astype(
        np.float32)
    want = japply(jnp.asarray(x))
    with torch.no_grad():
        got = tnet.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-3)


@pytest.mark.parametrize("attn_impl", ["flash", "splash", "xla"])
@pytest.mark.parametrize("name", ["tiny16", "medium"])
def test_taps_attention_routes_match_flax(name, attn_impl):
    """Every attn_impl against the JAX backbone with the same one on the
    CPU, where JAX takes its einsum (flash, splash) or XLA path."""
    _assert_taps_match(name, *_taps_pair(name, attn_impl))


@pytest.mark.parametrize("name", ["tiny16", "medium"])
def test_taps_unfused_mlp_match_flax(name, monkeypatch):
    """MLP_FUSE=False in both packages, the JAX fused kernels interpreted:
    the port's K1 + K6 plain versions against them."""
    from avlmaps_tpu.ops import fused_vit as jfv
    from avlmaps_torch.ops import fused_vit as tfv

    monkeypatch.setattr(jfv, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jfv, "MLP_FUSE", False)
    monkeypatch.setattr(tfv, "MLP_FUSE", False)
    _assert_taps_match(name, *_taps_pair(name, "fused"))
