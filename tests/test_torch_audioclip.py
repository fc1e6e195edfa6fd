"""The port's AudioCLIP (avlmaps_torch/models/audioclip) and its audio
helpers (avlmaps_torch/utils/audio.py) against the JAX package's, on the
CPU in f32.

Tolerances:

* the window, the framing, the adaptive max pool bins, the pose-free
  helpers and the FBSP grid at n_fft = 2048 are exact;
* ``fbsp_weights`` against the JAX function run op by op: atol 1e-7
  (cos and sin of the same f32 phases).  Inside one jitted JAX program
  XLA contracts the grid into fused multiply-adds elsewhere, which moves
  ``t`` by up to ~5 ulps (1.2e-6 at pi) and the phase fc * t by up to
  1.2e-3 rad at fc = 1024: times sqrt(fb) / sqrt(2048), entries move by
  up to ~4e-5, the bound held against the jitted function;
* the filterbank output: rtol 1e-5 (the port sums in f64, JAX in f32);
* embeddings are compared after L2 normalisation: the tiny towers at
  atol 1e-4, the full-width audio tower at cosine >= 0.9999 and atol
  1e-3.
"""

import dataclasses
import pathlib
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avlmaps_tpu.config import SoundConfig as JaxSoundConfig
from avlmaps_tpu.models.audioclip import AudioClip as JaxAudioClip
from avlmaps_tpu.models.audioclip import AudioClipConfig as JaxACConfig
from avlmaps_tpu.models.audioclip import AudioClipEncoder as JaxACEncoder
from avlmaps_tpu.models.audioclip import fbsp as jfbsp
from avlmaps_tpu.models.audioclip.esresnet import adaptive_max_pool
from avlmaps_tpu.models.audioclip.port import (
    config_from_state_dict as jax_config_from_state_dict,
    load_audioclip_checkpoint_with_config, port_audioclip_state_dict)
from avlmaps_tpu.models.clip.tokenizer import default_tokenizer
from avlmaps_tpu.utils import audio as jaudio
from avlmaps_torch.config import SoundConfig
from avlmaps_torch.models.audioclip import (AudioClip, AudioClipConfig,
                                            AudioClipEncoder, full_f32)
from avlmaps_torch.models.audioclip import fbsp as tfbsp
from avlmaps_torch.models.audioclip import port as tport
from avlmaps_torch.utils import audio as taudio

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from tests.test_audioclip_port import synth_state_dict  # noqa: E402


def _norm(z):
    z = np.asarray(z, np.float64)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


# -- FBSP front end ---------------------------------------------------------


@pytest.mark.parametrize("n", [48, 1654, 7])
def test_blackmanharris_window_is_jax_and_scipy(n):
    from scipy.signal import get_window

    got = tfbsp.blackmanharris_window(n)
    np.testing.assert_array_equal(got, jfbsp.blackmanharris_window(n))
    np.testing.assert_allclose(got, get_window("blackmanharris", n),
                               atol=1e-12)


@pytest.mark.parametrize("t", [30, 48, 1000, 2048, 8192])
def test_frame_signal_matches_jax(rng, t):
    x = rng.normal(size=(2, t)).astype(np.float32)
    win = tfbsp.blackmanharris_window(48).astype(np.float32)
    want = np.asarray(jfbsp.frame_signal(jnp.asarray(x), 48, 32,
                                         jnp.asarray(win)))
    got = tfbsp.frame_signal(torch.from_numpy(x), 48, 32,
                             torch.from_numpy(win)).numpy()
    np.testing.assert_array_equal(got, want)
    bare = tfbsp.frame_signal(torch.from_numpy(x), 48, 32).numpy()
    np.testing.assert_array_equal(
        bare, np.asarray(jfbsp.frame_signal(jnp.asarray(x), 48, 32)))


def test_fbsp_grid_is_jax_bits_at_full_width():
    want = np.asarray(np.pi * jnp.linspace(-1.0, 1.0, 2048).reshape(1, -1)
                      + 1e-8)
    got = tfbsp.fbsp_grid(2048).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 2048)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m_kind", ["one", "fractional", "zero"])
def test_fbsp_weights_match_jax(rng, m_kind):
    n_out = 1025
    m = {"one": np.ones(n_out), "zero": np.zeros(n_out),
         "fractional": rng.uniform(0.3, 2.5, n_out)}[m_kind]
    m = m.astype(np.float32)
    fb = rng.uniform(0.5, 2.0, n_out).astype(np.float32)
    fc = np.arange(n_out, dtype=np.float32)
    got = tfbsp.fbsp_weights(*(torch.from_numpy(a) for a in (m, fb, fc)),
                             2048).numpy()
    assert got.shape == (n_out, 2048, 2) and got.dtype == np.float32
    args = tuple(jnp.asarray(a) for a in (m, fb, fc))
    eager = np.asarray(jfbsp.fbsp_weights(*args, 2048))
    np.testing.assert_allclose(got, eager, atol=1e-7)
    jitted = np.asarray(jax.jit(
        lambda *a: jfbsp.fbsp_weights(*a, 2048))(*args))
    np.testing.assert_allclose(got, jitted, atol=4e-5)


def test_fbsp_apply_matches_jax(rng):
    frames = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(33, 64, 2)).astype(np.float32) * 0.1
    want = np.asarray(jfbsp.fbsp_apply(jnp.asarray(frames), jnp.asarray(w)))
    got = tfbsp.fbsp_apply(torch.from_numpy(frames), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 33, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_fbsp_apply_sums_silence_alike_in_any_order():
    """A constant frame (the zero padding after scale_signal) nearly
    cancels: the f64 sums give the same bins whatever the order of the
    terms, to f32 rounding."""
    x = tfbsp.scale_signal(torch.zeros(1, 1, 2048))
    w = tfbsp.fbsp_weights(torch.ones(1025), torch.ones(1025),
                           torch.arange(1025.0), 2048)
    perm = torch.randperm(2048, generator=torch.Generator().manual_seed(0))
    a = tfbsp.fbsp_apply(x, w)
    b = tfbsp.fbsp_apply(x[..., perm], w[:, perm])
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_scale_signal_matches_jax(rng):
    x = rng.uniform(-32768, 32767, 100).astype(np.float32)
    np.testing.assert_array_equal(
        tfbsp.scale_signal(torch.from_numpy(x)).numpy(),
        np.asarray(jfbsp.scale_signal(jnp.asarray(x))))


@pytest.mark.parametrize("in_hw,out_hw", [((7, 13), (3, 5)),
                                          ((11, 5), (4, 2)),
                                          ((9, 9), (1, 1)),
                                          ((6, 10), (6, 10)),
                                          ((5, 3), (2, 3))])
def test_adaptive_max_pool_bins_match_jax(rng, in_hw, out_hw):
    x = rng.normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(adaptive_max_pool(jnp.asarray(x), *out_hw))
    got = F.adaptive_max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                out_hw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


# -- towers -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """Tiny towers from a reference-layout state dict with random BN
    statistics, through the JAX porter and then the bridge."""
    jcfg = JaxACConfig.tiny()
    sd = synth_state_dict(jcfg, np.random.default_rng(7))
    variables = port_audioclip_state_dict(sd, jcfg)
    model = AudioClip(AudioClipConfig.tiny(), device="cpu").eval()
    model.load_state_dict(tport.params_from_flax(variables), strict=True)
    return JaxAudioClip(jcfg), variables, model, sd


def test_tiny_audio_tower_matches_jax(tiny):
    jm, variables, model, _ = tiny
    audio = (np.random.default_rng(1).normal(size=(3, 2048)) * 8000
             ).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(audio),
                    method=JaxAudioClip.encode_audio)
    with torch.no_grad():
        got = model.encode_audio(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(_norm(got), _norm(want), atol=1e-4)


def test_tiny_image_tower_matches_jax(tiny):
    jm, variables, model, _ = tiny
    img = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = jm.apply(variables, jnp.asarray(img),
                    method=JaxAudioClip.encode_image)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(_norm(got), _norm(want), atol=1e-4)


def test_tiny_text_tower_and_logits_match_jax(tiny):
    jm, variables, model, _ = tiny
    tokens = default_tokenizer()(["a dog barking", "glass breaking",
                                  "rain"], 16)
    want = jm.apply(variables, jnp.asarray(tokens),
                    method=JaxAudioClip.encode_text)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(_norm(got), _norm(want), atol=1e-4)
    audio = (np.random.default_rng(4).normal(size=(2, 2048)) * 8000
             ).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_tri_modal_matches_jax(tiny):
    """The three clamped-scale logit matrices (audio x image, audio x
    text, image x text): the tiny towers' logit tolerance above."""
    jm, variables, model, _ = tiny
    r = np.random.default_rng(5)
    audio = (r.normal(size=(2, 2048)) * 8000).astype(np.float32)
    img = r.normal(size=(3, 32, 32, 3)).astype(np.float32)
    tokens = default_tokenizer()(["a dog barking", "glass breaking",
                                  "rain", "a siren"], 16)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(img),
                    jnp.asarray(tokens), method=JaxAudioClip.tri_modal)
    with torch.no_grad():
        got = model.tri_modal(torch.from_numpy(audio), torch.from_numpy(img),
                              torch.from_numpy(tokens))
    for g, w, shape in zip(got, want, [(2, 3), (2, 4), (3, 4)]):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def test_full_width_audio_tower_matches_jax(rng):
    """AudioClipConfig()'s ESResNeXt-50 32x4d on an 8192-sample clip (13
    frames)."""
    jcfg = JaxACConfig()
    variables = port_audioclip_state_dict(
        synth_state_dict(jcfg, np.random.default_rng(0)), jcfg)
    audio = (rng.normal(size=(1, 8192)) * 8000).astype(np.float32)
    want = jax.jit(lambda v, a: JaxAudioClip(jcfg).apply(
        v, a, method=JaxAudioClip.encode_audio))(variables,
                                                  jnp.asarray(audio))
    model = AudioClip(AudioClipConfig(), device="cpu").eval()
    model.load_state_dict(tport.params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model.encode_audio(torch.from_numpy(audio)).numpy()
    assert got.shape == (1, 1024)
    a, b = _norm(got), _norm(want)
    assert float((a * b).sum()) >= 0.9999
    np.testing.assert_allclose(a, b, atol=1e-3)


# -- weights ----------------------------------------------------------------


def _strip(d):
    return {k: _strip(v) if isinstance(v, dict) else v
            for k, v in d.items() if k != "dtype"}


def test_checkpoint_loader_matches_the_jax_porter(tiny, tmp_path):
    """The reference .pt layout read by the port's loader against the JAX
    porter on the same state dict.  Both packages read the config off the
    shapes, which do not hold the spectrogram's window and hop (they stay
    the full-width model's), so the tiny weights run in the tiny model."""
    jm, jvars, _, sd = tiny
    path = tmp_path / "AudioCLIP-Partial-Training.pt"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    inferred, params = tport.load_audioclip_checkpoint(str(path))
    assert inferred == tport.config_from_state_dict(sd)
    assert dataclasses.asdict(inferred) == _strip(dataclasses.asdict(
        jax_config_from_state_dict(sd)))
    assert dataclasses.asdict(inferred) == _strip(dataclasses.asdict(
        load_audioclip_checkpoint_with_config(str(path))[0]))
    cfg = AudioClipConfig.tiny()
    model = AudioClip(cfg, device="cpu").eval()
    model.load_state_dict(params, strict=True)
    audio = (np.random.default_rng(5).normal(size=(2, 2048)) * 8000
             ).astype(np.float32)
    img = np.random.default_rng(6).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    tokens = default_tokenizer()(["door knock"], cfg.context_length)
    with torch.no_grad():
        for method, x in (("encode_audio", audio), ("encode_image", img),
                          ("encode_text", tokens)):
            want = jm.apply(jvars, jnp.asarray(x),
                            method=getattr(JaxAudioClip, method))
            got = getattr(model, method)(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(_norm(got), _norm(want), atol=1e-4)
    assert float(model.logit_scale_at.detach()) == pytest.approx(np.log(50.0))


def test_checkpoint_loader_refuses_what_it_cannot_read(tiny, tmp_path):
    _, _, _, sd = tiny
    partial = {k: v for k, v in sd.items() if not k.startswith("audio.att5")}
    with pytest.raises(KeyError, match="lacks 8 keys"):
        tport.state_dict_from_reference(partial, AudioClipConfig.tiny())
    # a pre-ported .msgpack needs its config sidecar (the JAX loader's
    # message; tests/test_torch_msgpack.py loads a complete pair)
    path = tmp_path / "audioclip.msgpack"
    path.write_bytes(b"\x80")  # an empty msgpack map
    with pytest.raises(FileNotFoundError) as terr:
        tport.load_audioclip_checkpoint(str(path))
    with pytest.raises(FileNotFoundError) as jerr:
        load_audioclip_checkpoint_with_config(str(path))
    assert str(terr.value) == str(jerr.value)


def test_seeded_weights_fill_every_parameter():
    cfg = AudioClipConfig.tiny()
    a = tport.init_params(cfg, torch.Generator().manual_seed(3))
    b = tport.init_params(cfg, torch.Generator().manual_seed(3))
    want = AudioClip(cfg, device="meta").state_dict()
    assert a.keys() == want.keys()
    for k in a:
        assert a[k].shape == want[k].shape
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    np.testing.assert_array_equal(a["audio.fbsp.fc"].numpy(),
                                  np.arange(33, dtype=np.float32))
    assert float(a["audio.fbsp.m"].abs().max()) == 0.0
    assert float(a["logit_scale_at"]) == pytest.approx(np.log(100.0))


def test_every_tensor_is_made_on_the_model_device():
    model = AudioClip(AudioClipConfig.tiny(), device="meta")
    devices = {t.device.type for t in list(model.parameters())
               + list(model.buffers())}
    assert devices == {"meta"}


# -- the encoder the sound map uses -------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxACEncoder(JaxACConfig.tiny(), seed=0)
    tenc = AudioClipEncoder(AudioClipConfig.tiny(),
                            params=tport.params_from_flax(jenc.params),
                            device="cpu")
    return jenc, tenc


def test_encode_audio_batch_matches_jax(encoders):
    """13 clips: a full batch of 10 and one of 3 filled up with its last
    clip; clips longer and shorter than the sample length.  The encoded
    clips are padded by at most two samples: a frame of zero padding is a
    constant after scale_signal, and the JAX package's f32 filterbank sums
    on it are rounding noise (see test_fbsp_apply_sums_silence_alike_in_
    any_order), so only the padding itself is compared on shorter clips."""
    jenc, tenc = encoders
    rng = np.random.default_rng(8)
    for n in (1000, 900, 2047, 5000):
        c = (rng.normal(size=n) * 6000).astype(np.float32)
        np.testing.assert_array_equal(tenc.prepare_audio(c),
                                      jenc.prepare_audio(c))
    clips = [(rng.normal(size=n) * 6000).astype(np.float32)
             for n in (2048, 2100, 3000, 2047, 5000, 2048, 2200, 2500, 2048,
                       4096, 2049, 2048, 2046)]
    got = tenc.encode_audio_batch(clips)
    want = jenc.encode_audio_batch(clips)
    assert got.shape == (13, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    texts = [["dog"], ["glass_breaking", "clapping"], "rain"]
    tfe = tenc.encode_text(texts)
    np.testing.assert_allclose(tfe, jenc.encode_text(texts), atol=1e-4)
    np.testing.assert_allclose(tenc.audio_text_logits(got, tfe),
                               jenc.audio_text_logits(want, tfe), atol=1e-3)


def test_full_f32_switches_tf32_off_only_inside():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 == before[1]
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]


def test_encoder_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        AudioClipEncoder(AudioClipConfig.tiny())


# -- audio helpers -----------------------------------------------------------


def test_wav_round_trip_and_resampling_match_jax(tmp_path, rng):
    audio = np.clip(rng.normal(size=4000) * 0.3, -1, 1).astype(np.float32)
    path = tmp_path / "a.wav"
    taudio.write_wav(path, audio, 8000)
    jpath = tmp_path / "b.wav"
    jaudio.write_wav(jpath, audio, 8000)
    assert path.read_bytes() == jpath.read_bytes()
    for sr in (None, 8000, 11025, 44100):
        got, gsr = taudio.read_wav(path, sr)
        want, wsr = jaudio.read_wav(path, sr)
        assert gsr == wsr and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    stereo = tmp_path / "stereo.wav"
    with wave.open(str(stereo), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes((rng.normal(size=(100, 2)) * 3000).astype(
            np.int16).tobytes())
    np.testing.assert_array_equal(taudio.read_wav(stereo)[0],
                                  jaudio.read_wav(stereo)[0])


def test_segmentation_and_contexts_match_jax(rng):
    sr = 8000
    audio = np.zeros(6 * sr, np.float32)
    for s0, n in ((0, 4000), (int(1.7 * sr), 3000), (int(2.5 * sr), 500),
                  (5 * sr, 4000)):
        audio[s0:s0 + n] = rng.normal(size=n)
    for gap, thres in ((1.0, 0.0), (0.5, 0.2), (3.0, 0.0)):
        got = taudio.segment_audio_with_silence(audio, gap, thres, sr)
        want = jaudio.segment_audio_with_silence(audio, gap, thres, sr)
        assert got[0] == want[0] and len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        assert taudio.convert_time_ranges_to_frame_ranges(got[0], 25) == \
            jaudio.convert_time_ranges_to_frame_ranges(want[0], 25)
    assert taudio.segment_audio_with_silence(np.zeros(10), 1.0) == ([], [])
    for center in (0.5, 2.5, 5.9, 9.0):
        got = taudio.get_five_second_context(audio, center, sr)
        want = jaudio.get_five_second_context(audio, center, sr)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_paths_and_level_categories_match_jax(tmp_path, monkeypatch):
    for name in ("000002", "000000", "000001"):
        (tmp_path / "audio_video" / name).mkdir(parents=True)
    (tmp_path / "audio_video" / "notes.txt").write_text("")
    assert taudio.setup_audio_paths(tmp_path) == \
        jaudio.setup_audio_paths(tmp_path)
    assert taudio.setup_audio_paths(tmp_path / "none")[1] == []
    for level in ("level_1", "level_3", "level_5"):
        want = jaudio.get_level_categories(level, JaxSoundConfig())
        assert taudio.get_level_categories(level, SoundConfig()) == want
        raw = {"difficulty": SoundConfig().difficulty,
               "major_categories": SoundConfig().major_categories}
        assert taudio.get_level_categories(level, raw) == want
    monkeypatch.setattr(taudio.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        taudio.extract_audio_from_video(tmp_path / "v.mp4",
                                        tmp_path / "a.wav")
