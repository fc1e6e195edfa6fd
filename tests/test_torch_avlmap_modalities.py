"""The port's AVLMap with its area and sound maps against the JAX package's,
on the CPU, on the synthetic scene of tests/test_avlmap.py with tiny
encoders (the port's weights come from the JAX package's through the
bridges).

The scene's two sound events are noisy tones of 3 s, so the 2048-sample
centre crop of each 5 s context that the tiny audio tower sees holds
sound: on the zero padding behind a short event the JAX package's f32
filterbank sums are rounding noise (the port sums them in f64, see
avlmaps_torch/models/audioclip/fbsp.py), and two such noises do not
agree.

Each package runs ``create_map`` on its own copy of the scene, then each
package's ``load_map`` reads both copies, so every query is compared on
the same artifacts, whichever package wrote them.  The two VLMaps may
hold different voxel sets (the port builds from half-resolution LSeg
features), which is why the queries are compared on one loaded scene at
a time.

Tolerances: CLIP image and AudioCLIP features are L2-normalised f32
results of the same arithmetic summed in another order (atol 1e-5); the
2D heats, their 3D lifts and object x area are held at atol 1e-5, and
the u8 heats to the same step wherever the f32 heats are farther than
that from a half step; pose tracks, event counts, grid cells and sound
locations are exact.
"""

import pickle
import shutil
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map import voxel_map as jax_voxel_map
from avlmaps_tpu.map.avlmap import AVLMap as JaxAVLMap
from avlmaps_tpu.models.audioclip import AudioClipConfig as JaxACConfig
from avlmaps_tpu.models.audioclip import AudioClipEncoder as JaxACEncoder
from avlmaps_tpu.models.clip import ClipConfig as JaxClipConfig
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_tpu.ops import delivery as jax_dlv
from avlmaps_torch.config import load_config
from avlmaps_torch.map import voxel_map as torch_voxel_map
from avlmaps_torch.map.avlmap import AVLMap
from avlmaps_torch.models import audioclip as tac
from avlmaps_torch.models.audioclip import port as ac_port
from avlmaps_torch.models.clip import ClipConfig, ClipEncoder
from avlmaps_torch.models.clip import params_from_flax as clip_from_flax
from avlmaps_torch.models.lseg import LSegConfig, LSegNet
from avlmaps_torch.models.lseg import params_from_flax as lseg_from_flax
from avlmaps_torch.ops import delivery as dlv
from avlmaps_torch.utils.audio import write_wav

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests.test_avlmap import CS, GS, H, VH, W, write_scene  # noqa: E402

ATOL = 1e-5
TINY_CLIP = dict(embed_dim=24, image_size=32, patch_size=8, vision_width=32,
                 vision_layers=2, text_width=32, text_layers=2, text_heads=2,
                 context_length=16)
MP3D = ["void", "chair", "table", "sofa", "objects"]


def _configure(cfg):
    cfg.map_config.grid_size = GS
    cfg.map_config.cell_size = CS
    cfg.params.gs = GS
    cfg.params.cs = CS
    cfg.map_config.pose_info.camera_height = CS * VH
    cfg.map_config.cam_calib_mat = tuple(
        np.array([[W / 2, 0, W / 2], [0, W / 2, H / 2], [0, 0, 1]],
                 np.float64).reshape(-1))
    cfg.map_config.capacity = 8192
    cfg.map_config.depth_sample_rate = 8
    cfg.map_config.max_pts_per_frame = 128
    cfg.map_config.lseg_base_size = W
    cfg.map_config.lseg_crop_size = W
    cfg.sound_data_collect_params.sample_rate = 8000
    cfg.sound_data_collect_params.fps = 25
    return cfg


def write_sound_events(scene: Path, sr: int = 8000, fps: int = 25):
    """Replace the scene's sequence with two 3 s noisy tones 1.5 s apart
    and a pose track over its 8 s."""
    seq = scene / "audio_video" / "000000"
    rng = np.random.default_rng(3)
    t = np.arange(3 * sr) / sr
    audio = np.zeros(8 * sr, np.float32)
    for start, hz in ((0, 600), (int(4.5 * sr), 200)):
        audio[start:start + t.size] = (0.3 * np.sin(2 * np.pi * hz * t)
                                       + 0.1 * rng.normal(size=t.size))
    write_wav(seq / "audio.wav", np.clip(audio, -1, 1), sr)
    np.savetxt(seq / "poses.txt", np.asarray(
        [[0.02 * i, 0.01 * (i % 7), 0.0, 0.0, 0.0, 0.0, 1.0]
         for i in range(8 * fps)]))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("modalities")
    jscene = write_scene(root / "jax")
    write_sound_events(jscene)
    tscene = root / "torch"
    shutil.copytree(jscene, tscene)

    jclip = JaxClipEncoder.from_config(JaxClipConfig(**TINY_CLIP))
    tclip = ClipEncoder.from_config(ClipConfig(**TINY_CLIP),
                                    params=clip_from_flax(jclip.params),
                                    device="cpu")
    jaudio = JaxACEncoder(JaxACConfig.tiny())
    taudio = tac.AudioClipEncoder(tac.AudioClipConfig.tiny(),
                                  params=ac_port.params_from_flax(
                                      jaudio.params), device="cpu")
    jnet = JaxLSegNet(JaxLSegConfig.tiny16())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, H, W, 3), jnp.float32))
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    tnet.load_state_dict(lseg_from_flax(variables), strict=True)

    jm = JaxAVLMap(_configure(jax_load_config()), data_dir=str(jscene),
                   clip_encoder=jclip, area_clip_encoder=jclip,
                   audioclip_encoder=jaudio)
    jm.vlmap.set_lseg(jnet.apply, variables, feat_dim=24)
    assert jm.create_map(jscene)
    tm = AVLMap(_configure(load_config()), data_dir=str(tscene),
                clip_encoder=tclip, area_clip_encoder=tclip,
                audioclip_encoder=taudio, device="cpu")
    tm.vlmap.set_lseg(lambda x: tnet(x, upsample=False), 24)
    assert tm.create_map(tscene)
    return {"jax": jscene, "torch": tscene, "jm": jm, "tm": tm}


@pytest.fixture(scope="module", params=["jax", "torch"])
def loaded(request, built):
    """Both packages' maps loaded from the scene the named package built."""
    scene = built[request.param]
    jm, tm = built["jm"], built["tm"]
    assert jm.load_map(scene) and tm.load_map(scene)
    return jm, tm


def test_each_package_writes_its_artifacts(built):
    for scene in (built["jax"], built["torch"]):
        assert (scene / "vlmap" / "vlmaps.h5df").exists()
        assert (scene / "area_map" / "clip_sparse_map.h5df").exists()
        assert (scene / "audio_video" / "audio_data_level_3.pkl").exists()


def test_clip_sparse_maps_and_poses_agree(built):
    jfeat, jposes = jax_voxel_map.load_clip_sparse_map(
        built["jax"] / "area_map" / "clip_sparse_map.h5df")
    tfeat, tposes = torch_voxel_map.load_clip_sparse_map(
        built["torch"] / "area_map" / "clip_sparse_map.h5df")
    assert tfeat.dtype == np.float32 and tfeat.shape == jfeat.shape == (4, 24)
    np.testing.assert_allclose(tfeat, jfeat, atol=ATOL)
    assert tposes.dtype == np.float64 and tposes.shape == (4, 4, 4)
    np.testing.assert_array_equal(tposes, jposes)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_clip_sparse_map_reads_across_packages(built, writer):
    """The JAX package writes with h5py, the port with its own codec: each
    package and h5py read the other's file to the same arrays."""
    path = built[writer] / "area_map" / "clip_sparse_map.h5df"
    with h5py.File(str(path), "r") as f:
        want = f["clip_sparse_map"][()], f["robot_pose_list"][()]
    for load in (jax_voxel_map.load_clip_sparse_map,
                 torch_voxel_map.load_clip_sparse_map):
        got = load(path)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _database(scene):
    with open(scene / "audio_video" / "audio_data_level_3.pkl", "rb") as f:
        return pickle.load(f)


def test_audio_databases_agree(built):
    jdb, tdb = _database(built["jax"]), _database(built["torch"])
    assert len(jdb) == len(tdb) == 2  # the scene's two tones
    for i in range(2):
        tf, jf = tdb[i]["audio_features"], jdb[i]["audio_features"]
        assert isinstance(tf, np.ndarray) and tf.dtype == np.float32
        np.testing.assert_allclose(tf, jf, atol=ATOL)
        assert len(tdb[i]["locations"]) == len(jdb[i]["locations"]) > 0
        for a, b in zip(tdb[i]["locations"], jdb[i]["locations"]):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_audio_database_reads_across_packages(built, writer):
    """The pickle holds numpy arrays only: each package loads the other's
    database to the same values."""
    want = _database(built[writer])
    for m in (built["jm"], built["tm"]):
        got = m.sound_map.load_sound_map(built[writer])
        assert got.keys() == want.keys()
        for i in want:
            np.testing.assert_array_equal(got[i]["audio_features"],
                                          want[i]["audio_features"])


def _assert_u8_agrees(got, want, want_f32):
    """u8 heats agree where the f32 heats (held at ATOL) cannot round to
    different steps: everywhere but within ATOL of a half step, where
    they may differ by that one step."""
    assert got.dtype == np.float32 and got.shape == want.shape
    steps = np.rint((got - want) * 255.0)
    assert np.abs(steps).max() <= 1
    half = np.abs(want_f32 * 255.0 - np.floor(want_f32 * 255.0) - 0.5)
    np.testing.assert_array_equal(got[half > 255.0 * ATOL],
                                  want[half > 255.0 * ATOL])


@pytest.mark.parametrize("delivery", ["f32", "u8"])
def test_index_area_2d_agrees(loaded, delivery):
    jm, tm = loaded
    want = jm.index_area_2d("kitchen", delivery=delivery)
    got = tm.index_area_2d("kitchen", delivery=delivery)
    assert isinstance(got, np.ndarray) and got.shape == (GS, GS)
    if delivery == "f32":
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert got.max() == 1.0 and got.min() == 0.0
    else:
        _assert_u8_agrees(got, want, jm.index_area_2d("kitchen"))
        np.testing.assert_array_equal(
            got, dlv.dequantize_heat_u8(dlv.fetch_np(dlv.quantize_heat_u8(
                tm.index_area_2d("kitchen", delivery="device")))))


@pytest.mark.parametrize("delivery", ["f32", "u8"])
def test_index_sound_2d_agrees(loaded, delivery):
    jm, tm = loaded
    want = jm.index_sound_2d("glass_breaking", delivery=delivery)
    got = tm.index_sound_2d("glass_breaking", delivery=delivery)
    assert isinstance(got, np.ndarray) and got.shape == (GS, GS)
    if delivery == "f32":
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert got.max() == 1.0
    else:
        _assert_u8_agrees(got, want, jm.index_sound_2d("glass_breaking"))
        np.testing.assert_array_equal(
            got, dlv.dequantize_heat_u8(dlv.fetch_np(dlv.quantize_heat_u8(
                tm.index_sound_2d("glass_breaking", delivery="device")))))


def test_device_delivery_is_a_tensor(loaded):
    _, tm = loaded
    for query in (tm.index_area_2d, tm.index_sound_2d):
        heat = query("kitchen", delivery="device")
        assert isinstance(heat, torch.Tensor) and heat.shape == (GS, GS)
        np.testing.assert_array_equal(heat.numpy(), query("kitchen"))
    with pytest.raises(ValueError, match="delivery"):
        tm.index_area_2d("kitchen", delivery="f16")


def test_index_area_and_sound_lift_agree(loaded):
    jm, tm = loaded
    n = tm.vlmap.grid_pos.shape[0]
    for name, query in (("kitchen", "index_area"),
                        ("dog", "index_sound")):
        got = getattr(tm, query)(name)
        assert got.shape == (n,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, getattr(jm, query)(name), atol=ATOL)


def test_sound_get_pos_agrees(loaded):
    jm, tm = loaded
    for name in ("glass_breaking", "dog", "clapping"):
        got, want = tm.sound_map.get_pos(name), jm.sound_map.get_pos(name)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # the category list's text features are encoded once and reused
    assert tm.sound_map._text_feat_cache is not None


def test_sound_get_pos_with_audio_agrees(loaded, tmp_path):
    from avlmaps_torch.utils.audio import write_wav

    jm, tm = loaded
    sr = 8000
    t = np.arange(sr) / sr
    path = tmp_path / "query.wav"
    write_wav(path, (0.4 * np.sin(2 * np.pi * 200 * t)).astype(np.float32),
              sr)
    got = tm.sound_map.get_pos_with_audio(str(path), sr)
    want = jm.sound_map.get_pos_with_audio(str(path), sr)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tm.sound_map.get_pos_with_audio(str(tmp_path / "none.wav"),
                                           sr) == []


def test_object_times_area_agrees(loaded):
    """The multimodal goal: object heat x area heat, fused on the device."""
    jm, tm = loaded
    kw = dict(init_categories=MP3D, decay_rate=0.01)
    jobj = jm.index_object("chair", **kw)
    tobj = tm.index_object("chair", delivery="device", **kw)
    np.testing.assert_allclose(tobj.numpy(), jobj, atol=ATOL)
    jarea, tarea = jm.index_area("kitchen"), tm.index_area("kitchen")
    pos, heat = dlv.fetch_np(*dlv.fused_goal_pick([tobj, tarea],
                                                  tm.vlmap.grid_pos))
    jpos, jheat = jax_dlv.fetch_np(*jax_dlv.fused_goal_pick(
        [jobj, jarea], jm.vlmap.grid_pos))
    np.testing.assert_allclose(heat, jheat, atol=ATOL)
    fused = jobj * jarea
    assert heat == pytest.approx(fused.max(), abs=ATOL)
    np.testing.assert_array_equal(pos, tm.vlmap.grid_pos[np.argmax(
        tobj.numpy() * tarea)])


def test_dataloader_is_built_on_the_loaded_vlmap(loaded):
    jm, tm = loaded
    assert tm.dataloader.map is tm.vlmap
    assert (tm.dataloader.rmin, tm.dataloader.cmin) == (jm.dataloader.rmin,
                                                        jm.dataloader.cmin)
    np.testing.assert_array_equal(tm.dataloader.obstacles_cropped,
                                  jm.dataloader.obstacles_cropped)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_visual_map_caches_agree_across_packages(built, writer):
    """Both packages build the visual map's descriptor cache in create_map
    (the tiny CLIP image tower, 24-d); each file reads to one array
    through h5py and the port's codec, and the two packages' caches
    agree."""
    from avlmaps_torch.map import hdf5

    path = built[writer] / "visual_map" / "global_descriptors_24.h5df"
    with h5py.File(str(path), "r") as f:
        want = f["descriptors"][()]
    assert want.shape == (4, 24) and want.dtype == np.float32
    np.testing.assert_array_equal(hdf5.read(path)["descriptors"], want)
    other = built["torch" if writer == "jax" else "jax"]
    with h5py.File(str(other / "visual_map" / "global_descriptors_24.h5df"),
                   "r") as f:
        np.testing.assert_allclose(f["descriptors"][()], want, atol=ATOL)


def _frame(scene, i):
    from avlmaps_torch.pipeline.loader import load_rgb

    return load_rgb(scene / "rgb" / f"{i:06d}.png")


def test_index_image_agrees(loaded, built):
    """A mapping frame as the query: retrieval finds it, the 32x32 frame
    gives ORB nothing to match, so both packages fall back to its pose;
    the heat is the same f32 formula, to the bit."""
    jm, tm = loaded
    n = tm.vlmap.grid_pos.shape[0]
    for i in (1, 3):
        query = _frame(built["jax"], i)
        assert int(tm.visual_map.retrieve(query)[0]) == i
        for decay in (0.01, 0.2):
            got = tm.index_image(query, decay_rate=decay)
            want = jm.index_image(query, decay_rate=decay)
            assert got.dtype == np.float32 and got.shape == (n,)
            np.testing.assert_array_equal(got, want)
        assert 0.0 < got.max() <= 1.0 and got.min() < got.max()
        dev = tm.index_image(query, delivery="device")
        assert isinstance(dev, torch.Tensor)
        np.testing.assert_array_equal(dev.numpy(), tm.index_image(query))
    with pytest.raises(ValueError, match="delivery"):
        tm.index_image(query, delivery="u8")


def test_object_times_image_agrees(loaded, built):
    """The object x image goal, fused on the device."""
    jm, tm = loaded
    query = _frame(built["jax"], 2)
    kw = dict(init_categories=MP3D, decay_rate=0.01)
    tobj = tm.index_object("chair", delivery="device", **kw)
    timg = tm.index_image(query, decay_rate=0.05, delivery="device")
    jobj = jm.index_object("chair", **kw)
    jimg = jm.index_image(query, decay_rate=0.05)
    pos, heat = dlv.fetch_np(*dlv.fused_goal_pick([tobj, timg],
                                                  tm.vlmap.grid_pos))
    _, jheat = jax_dlv.fetch_np(*jax_dlv.fused_goal_pick(
        [jobj, jimg], jm.vlmap.grid_pos))
    np.testing.assert_allclose(heat, jheat, atol=ATOL)
    fused = tobj.numpy() * timg.numpy()
    np.testing.assert_array_equal(pos, tm.vlmap.grid_pos[np.argmax(fused)])
