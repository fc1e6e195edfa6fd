"""The port's Wav2CLIP (avlmaps_torch/models/wav2clip.py) and ESC-50
metadata (avlmaps_torch/utils/esc50.py) against the JAX package's, on the
CPU in f32.

Tolerances: the mel filterbank is exact (the same f64 host code); the
log-mel spectrogram at atol 1e-3 (pocketfft and XLA's CPU FFT round
differently, and the log magnifies quiet bins); embeddings after L2
normalisation at atol 1e-4 and, at full width, cosine >= 0.9999; the
state-dict port is exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models import wav2clip as jw2c
from avlmaps_tpu.models.clip import ClipConfig as JaxClipConfig
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.utils.esc50 import ESC50Meta as JaxESC50Meta
from avlmaps_torch.models import wav2clip as tw2c
from avlmaps_torch.models.clip import ClipConfig, ClipEncoder
from avlmaps_torch.models.clip import params_from_flax as clip_from_flax
from avlmaps_torch.utils.esc50 import ESC50Meta

TINY = tw2c.Wav2ClipConfig.tiny()
TINY_CLIP = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=32,
                 vision_layers=2, text_width=32, text_layers=2, text_heads=2,
                 context_length=16)


def _variables(cfg=jw2c.Wav2ClipConfig.tiny(), seed=0):
    """Flax Wav2Clip variables with BN statistics and biases moved off
    their initial values, so the frozen-BN mapping is exercised."""
    model = jw2c.Wav2Clip(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 1600), jnp.float32))
    noise = np.random.default_rng(seed + 1)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return a * noise.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a + noise.normal(size=a.shape).astype(np.float32) * 0.05

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("cfg", [TINY, tw2c.Wav2ClipConfig()],
                         ids=["tiny", "full"])
def test_filterbank_and_log_mel_match_jax(cfg, rng):
    jcfg = jw2c.Wav2ClipConfig(**{f: getattr(cfg, f) for f in (
        "sample_rate", "n_fft", "hop_length", "n_mels", "embed_dim",
        "width", "layers")})
    np.testing.assert_array_equal(
        tw2c.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels),
        jw2c.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels))
    audio = (rng.normal(size=(2, 4000)) * 0.1).astype(np.float32)
    want = np.asarray(jw2c.log_mel_spectrogram(jnp.asarray(audio), jcfg))
    got = tw2c.log_mel_spectrogram(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.n_mels,
                                       1 + 4000 // cfg.hop_length)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_forward_matches_jax_on_bridged_weights(rng):
    variables = _variables()
    net = tw2c.Wav2Clip(TINY, device="cpu")
    net.load_state_dict(tw2c.params_from_flax(variables), strict=True)
    audio = (rng.normal(size=(3, 1500)) * 0.2).astype(np.float32)
    want = np.asarray(jw2c.Wav2Clip(jw2c.Wav2ClipConfig.tiny()).apply(
        variables, jnp.asarray(audio)))
    with torch.no_grad():
        got = net(torch.from_numpy(audio)).numpy()

    def unit(z):
        return z / np.linalg.norm(z, axis=1, keepdims=True)

    np.testing.assert_allclose(unit(got), unit(want), atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_state_dict_port_matches_jax():
    """A torchvision-layout resnet18 under the release's ``encoder.``
    prefix, with BN's num_batches_tracked: the same tensors as the JAX
    porter's, and a clear error without the head."""
    g = torch.Generator().manual_seed(4)
    sd = {}
    for name, meta in tw2c.Wav2Clip(TINY, device="meta").state_dict().items():
        sd[f"encoder.{name}"] = torch.rand(tuple(meta.shape), generator=g) \
            + 0.5
        if name.endswith("running_var"):
            sd[f"encoder.{name[:-len('running_var')]}num_batches_tracked"] \
                = torch.tensor(7)
    got = tw2c.port_wav2clip_state_dict(sd, TINY)
    want = tw2c.params_from_flax(jw2c.port_wav2clip_state_dict(
        sd, jw2c.Wav2ClipConfig.tiny()))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    del sd["encoder.fc.weight"]
    with pytest.raises(KeyError, match="fc"):
        tw2c.port_wav2clip_state_dict(sd, TINY)


def test_encoder_surface_matches_jax(rng):
    """embed_audio_batch (padding, batch fill), the sound map's surface
    (int16 scaling, entity lists joined) and the text scores through a
    bridged tiny CLIP."""
    jclip = JaxClipEncoder.from_config(JaxClipConfig(**TINY_CLIP))
    tclip = ClipEncoder.from_config(ClipConfig(**TINY_CLIP),
                                    params=clip_from_flax(jclip.params),
                                    device="cpu")
    jenc = jw2c.Wav2ClipEncoder(jw2c.Wav2ClipConfig.tiny(),
                                params=_variables(seed=2),
                                clip_encoder=jclip)
    tenc = tw2c.Wav2ClipEncoder(TINY,
                                params=tw2c.params_from_flax(jenc.params),
                                clip_encoder=tclip, device="cpu")
    clips = [(rng.normal(size=(n,)) * 0.2).astype(np.float32)
             for n in (900, 1500, 1200)]
    got = tenc.embed_audio_batch(clips, batch_size=2)
    np.testing.assert_allclose(got, jenc.embed_audio_batch(clips, 2),
                               atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    scaled = [c * 8000.0 for c in clips]
    np.testing.assert_allclose(tenc.encode_audio_batch(scaled),
                               jenc.encode_audio_batch(scaled), atol=1e-4)
    texts = [["glass breaking"], ["dog", "barking"], "rain"]
    tt, jt = tenc.encode_text(texts), jenc.encode_text(texts)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    np.testing.assert_allclose(tenc.audio_text_logits(got, tt),
                               jenc.audio_text_logits(got, jt), atol=1e-5)
    np.testing.assert_allclose(
        tenc.audio_text_scores(got, ["glass breaking", "dog"]),
        jenc.audio_text_scores(got, ["glass breaking", "dog"]), atol=1e-5)


def test_init_params_seeded_at_full_width():
    cfg = tw2c.Wav2ClipConfig()
    a = tw2c.init_params(cfg, torch.Generator().manual_seed(0))
    b = tw2c.init_params(cfg, torch.Generator().manual_seed(0))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert tuple(a["fc.weight"].shape) == (512, 512)
    assert tuple(a["layer4.0.downsample.0.weight"].shape) == (512, 256, 1, 1)


def test_esc50_meta_matches_jax(tmp_path):
    meta = tmp_path / "esc50.csv"
    meta.write_text(
        "filename,fold,target,category,esc10,src_file,take\n"
        "1-100032-A-0.wav,1,0,dog,True,100032,A\n"
        "1-100038-A-14.wav,1,14,chirping_birds,False,100038,A\n"
        "2-100648-A-43.wav,2,43,chirping_birds,False,100648,A\n"
        "1-101296-A-19.wav,1,19,thunderstorm,False,101296,A\n"
        "1-101296-B-19.wav,1,19,thunderstorm,False,101296,B\n")
    for fold in (1, 2):
        got = ESC50Meta(str(meta), str(tmp_path / "audio"), fold=fold)
        want = JaxESC50Meta(str(meta), str(tmp_path / "audio"), fold=fold)
        assert got.categories == want.categories
        assert got.path_to_category == want.path_to_category
        for cat in want.categories + ["rain"]:
            assert got.paths_for(cat) == want.paths_for(cat)
    assert ESC50Meta(str(meta), "a").paths_for("thunderstorm") == [
        Path("a") / "1-101296-A-19.wav", Path("a") / "1-101296-B-19.wav"]
