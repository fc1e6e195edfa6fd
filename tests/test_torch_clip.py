"""The port's CLIP (avlmaps_torch/models/clip) against the JAX package's,
on the CPU in f32: the tokenizer id for id, the weight bridge, the text
and image towers, the template ensemble and the OpenAI checkpoint loader.

Features are L2-normalised (entries ~0.05 to 0.2); both sides run the same
f32 arithmetic with sums in another order, so they are held at atol 1e-5.
"""

import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models.clip import Clip as JaxClip
from avlmaps_tpu.models.clip import ClipConfig as JaxClipConfig
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.models.clip import ClipTokenizer as JaxClipTokenizer
from avlmaps_tpu.models.clip.port import port_clip_state_dict
from avlmaps_torch.models.clip import (MULTIPLE_TEMPLATES, Clip, ClipConfig,
                                       ClipEncoder, ClipTokenizer,
                                       init_params, load_clip_checkpoint,
                                       params_from_flax)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from tools.torch_reference.clip_torch import (  # noqa: E402
    TorchClipText, TorchClipVision, export_visual_state_dict)

ATOL = 1e-5
NAMES = ["chair", "sofa table", "tv_monitor", "potted plant"]

TINY = dict(embed_dim=24, image_size=32, patch_size=8, vision_width=32,
            vision_layers=2, text_width=32, text_layers=2, text_heads=2)
# the ViT-B/32 text tower's width and heads, two layers deep
WIDE_TEXT = dict(embed_dim=512, image_size=32, patch_size=8, vision_width=32,
                 vision_layers=1, text_width=512, text_layers=2,
                 text_heads=8)
CONFIGS = {"tiny": TINY, "wide_text": WIDE_TEXT}


@functools.lru_cache(maxsize=None)
def _jax_encoder(name):
    """A JAX ClipEncoder with perturbed weights (non-trivial biases and LN
    scales), built once per config."""
    enc = JaxClipEncoder.from_config(JaxClipConfig(**CONFIGS[name]), seed=0)
    noise = np.random.default_rng(1)
    enc.params = jax.tree.map(
        lambda a: np.asarray(a) + noise.normal(size=a.shape).astype(
            np.float32) * 0.02, enc.params)
    return enc


def _pair(name):
    jenc = _jax_encoder(name)
    tenc = ClipEncoder.from_config(ClipConfig(**CONFIGS[name]),
                                   params=params_from_flax(jenc.params),
                                   device="cpu")
    return jenc, tenc


def test_tokenizer_ids_match_jax(tmp_path):
    prompts = [t.format(x) for x in NAMES for t in MULTIPLE_TEMPLATES]
    np.testing.assert_array_equal(ClipTokenizer()(prompts),
                                  JaxClipTokenizer()(prompts))
    merges = tmp_path / "merges.txt"
    merges.write_text("#version\nc h\na i\nai r</w>\nt a\n")
    np.testing.assert_array_equal(ClipTokenizer(str(merges))(prompts),
                                  JaxClipTokenizer(str(merges))(prompts))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_flax_loads_strictly(name):
    jenc = _jax_encoder(name)
    sd = params_from_flax(jenc.params)
    model = Clip(ClipConfig(**CONFIGS[name]), device="cpu")
    model.load_state_dict(sd, strict=True)
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(jenc.params))
    assert sum(t.numel() for t in sd.values()) == n_flax


def test_init_params_loads_strictly_at_full_shapes():
    cfg = ClipConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    model = Clip(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, gen), strict=True)
    tokens = ClipTokenizer()(NAMES, cfg.context_length)
    assert model.encode_text(torch.from_numpy(tokens)).shape == (4, 24)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_text_feats_match_jax(name):
    jenc, tenc = _pair(name)
    np.testing.assert_allclose(tenc.get_text_feats(NAMES),
                               jenc.get_text_feats(NAMES), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_template_ensemble_matches_jax(name):
    jenc, tenc = _pair(name)
    got = tenc.get_text_feats_multiple_templates(NAMES[:2])
    np.testing.assert_allclose(
        got, jenc.get_text_feats_multiple_templates(NAMES[:2]), atol=ATOL)
    dev = tenc.get_text_feats_multiple_templates(NAMES[:2], as_device=True)
    assert isinstance(dev, torch.Tensor) and dev.shape == (2, tenc.feat_dim)
    assert tenc.get_text_feats_multiple_templates([]).shape == (
        0, tenc.feat_dim)


def test_image_feats_match_jax():
    jenc, tenc = _pair("tiny")
    imgs = [np.random.default_rng(i).integers(0, 255, (40 + 9 * i, 48, 3),
                                              dtype=np.uint8)
            for i in range(3)]
    np.testing.assert_allclose(tenc.get_imgs_feats_batch(imgs, batch_size=2),
                               jenc.get_imgs_feats_batch(imgs, batch_size=2),
                               atol=ATOL)
    np.testing.assert_allclose(tenc.get_img_feats(imgs[0]),
                               jenc.get_img_feats(imgs[0]), atol=ATOL)


def test_lseg_score_and_argmax_match_jax():
    jenc, tenc = _pair("tiny")
    feats = np.random.default_rng(2).normal(size=(300, 24)).astype(
        np.float32)
    for kw in (dict(), dict(use_multiple_templates=True),
               dict(use_multiple_templates=True, avg_mode=1)):
        want = jenc.get_lseg_score(["chair", "table"], feats, **kw)
        np.testing.assert_allclose(
            tenc.get_lseg_score(["chair", "table"], feats, **kw), want,
            rtol=2e-4, atol=2e-3)
        np.testing.assert_array_equal(
            tenc.get_lseg_argmax(["chair", "table"], feats, **kw),
            jenc.get_lseg_argmax(["chair", "table"], feats, **kw))


def test_map_cache_detects_mutation_and_drops():
    _, tenc = _pair("tiny")
    feats = np.random.default_rng(1).normal(size=(128, 24)).astype(
        np.float32)
    first = tenc._map_feats_device(feats)
    assert tenc._map_feats_device(feats) is first
    feats *= 2.0
    np.testing.assert_array_equal(tenc._map_feats_device(feats).numpy(),
                                  feats)
    tenc.drop_map_cache()
    assert tenc._map_dev is None


def _openai_state_dict():
    """An OpenAI-layout CLIP state dict from the repository's torch
    oracles: the text tower of tools/torch_reference/clip_torch.py (the
    layout of tests/test_clip.py's oracle) and its ViT."""
    torch.manual_seed(0)
    text = TorchClipText(width=128, layers=2, heads=2, ctx=77,
                         embed_dim=64).eval()
    for p in text.parameters():  # non-trivial LN scales and biases
        p.data += torch.randn_like(p) * 0.02
    vision = TorchClipVision(image_size=32, patch_size=8, width=64,
                             layers=2, heads=1, embed_dim=64).eval()
    sd = dict(export_visual_state_dict(vision))
    sd["token_embedding.weight"] = text.token_embedding.weight
    sd["positional_embedding"] = text.positional_embedding
    sd["ln_final.weight"] = text.ln_final.weight
    sd["ln_final.bias"] = text.ln_final.bias
    sd["text_projection"] = text.text_projection
    for i, blk in enumerate(text.resblocks):
        p = f"transformer.resblocks.{i}"
        for name, t in (("ln_1", blk.ln_1), ("ln_2", blk.ln_2),
                        ("attn.out_proj", blk.attn.out_proj),
                        ("mlp.c_fc", blk.mlp.c_fc),
                        ("mlp.c_proj", blk.mlp.c_proj)):
            sd[f"{p}.{name}.weight"] = t.weight
            sd[f"{p}.{name}.bias"] = t.bias
        sd[f"{p}.attn.in_proj_weight"] = blk.attn.in_proj_weight
        sd[f"{p}.attn.in_proj_bias"] = blk.attn.in_proj_bias
    sd["logit_scale"] = torch.tensor(2.0)
    sd["context_length"] = torch.tensor(77)
    return {k: v.detach().clone() for k, v in sd.items()}, text, vision


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_clip_checkpoint_matches_jax_port(tmp_path, wrapped):
    sd, text, vision = _openai_state_dict()
    path = tmp_path / "clip.pt"
    torch.save({"state_dict": sd} if wrapped else sd, path)
    cfg, params = load_clip_checkpoint(str(path))
    assert (cfg.text_width, cfg.text_heads, cfg.vision_width,
            cfg.image_size) == (128, 2, 64, 32)
    tenc = ClipEncoder.from_config(cfg, params=params, device="cpu")

    jsd = {k: v for k, v in sd.items() if k != "context_length"}
    jcfg = JaxClipConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})
    jmodel, jvars = JaxClip(jcfg), port_clip_state_dict(jsd)
    tokens = ClipTokenizer()(NAMES, cfg.context_length)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(tokens),
                                   method=JaxClip.encode_text))
    with torch.no_grad():
        got = tenc.model.encode_text(torch.from_numpy(tokens)).numpy()
        oracle = text(torch.from_numpy(tokens.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)

    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x),
                                   method=JaxClip.encode_image))
    with torch.no_grad():
        got = tenc.model.encode_image(torch.from_numpy(x)).numpy()
        oracle = vision(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)


def test_cut_context_gives_the_full_context_features():
    """device_tokens cuts the ids after the batch's last EOT; the EOT features
    equal those of the full 77-token context."""
    _, tenc = _pair("wide_text")
    ids = ClipTokenizer()(NAMES, tenc.cfg.context_length)
    cut = tenc.device_tokens(NAMES)
    assert cut.shape[1] == int(ids.argmax(1).max()) + 1 < ids.shape[1]
    with torch.no_grad():
        full = tenc.model.encode_text(torch.from_numpy(ids))
        short = tenc.model.encode_text(cut)
    np.testing.assert_allclose(short.numpy(), full.numpy(), atol=ATOL)
