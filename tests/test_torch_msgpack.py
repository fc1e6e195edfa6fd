"""The port's reader of flax's msgpack files (avlmaps_torch/utils/
msgpack.py) against ``flax.serialization``, and the three ``.msgpack``
loaders (LSeg, CLIP, AudioCLIP) against the JAX package's.

Files are written by ``flax.serialization.to_bytes`` /
``msgpack_serialize``, as tools/port_checkpoints.py writes them.  The
reader must give every leaf flax gives: the same dtype, shape and bytes (a
bf16 leaf as a ``torch.bfloat16`` tensor with the same bits).  Forwards
through the loaded weights are held at the tolerances of the models' own
bridge tests (LSeg 5e-3, CLIP 1e-5, AudioCLIP 1e-4 after normalisation).
"""

import json
import pathlib
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from avlmaps_tpu.map.vlmap import load_lseg_params as jax_load_lseg
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.models.audioclip import AudioClip as JaxAudioClip
from avlmaps_tpu.models.audioclip import AudioClipConfig as JaxACConfig
from avlmaps_tpu.models.audioclip import port as jac_port
from avlmaps_tpu.models.clip import Clip as JaxClip
from avlmaps_tpu.models.clip import ClipConfig as JaxClipConfig
from avlmaps_tpu.models.clip import port as jclip_port
from avlmaps_tpu.models.clip.tokenizer import default_tokenizer
from avlmaps_tpu.models.lseg import LSegConfig as JaxLSegConfig
from avlmaps_tpu.models.lseg import LSegNet as JaxLSegNet
from avlmaps_torch.config import load_config
from avlmaps_torch.map.vlmap import VLMap, load_lseg_params
from avlmaps_torch.models.audioclip import AudioClip, AudioClipConfig
from avlmaps_torch.models.audioclip import port as tac_port
from avlmaps_torch.models.clip import Clip, ClipConfig, ClipEncoder
from avlmaps_torch.models.clip import port as tclip_port
from avlmaps_torch.models.lseg import LSegConfig, LSegNet
from avlmaps_torch.utils import msgpack

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from tests.test_audioclip_port import synth_state_dict  # noqa: E402


def _leaves(tree, path=()):
    """(path, leaf) pairs in key order; lists and tuples by index."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_same_leaf(path, got, want):
    if isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        bits = got.view(torch.int16).numpy().view(np.uint16)
        assert bits.tobytes() == np.asarray(want).view(np.uint16).tobytes()
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _assert_same_tree(got, want):
    got_l, want_l = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        _assert_same_leaf(path, g, w)


def _every_type(rng):
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=(7,)),
        "f16": rng.normal(size=(2, 2)).astype(np.float16),
        "bf16": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
        "ints": {name: rng.integers(-100, 100, (3, 2)).astype(name)
                 for name in ("int8", "int16", "int32", "int64")},
        "uints": {name: rng.integers(0, 200, (5,)).astype(name)
                  for name in ("uint8", "uint16", "uint32", "uint64")},
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"np_f32": np.float32(1.5), "np_i64": np.int64(-7),
                    "np_bf16": jnp.bfloat16(2.5).reshape(()),
                    "zero_d": np.asarray(3.0, np.float32)},
        "python": {"int": 7, "neg": -3, "i8": -100, "u16": 60000,
                   "i32": -70000, "u32": 4_000_000_000, "i64": -2 ** 40,
                   "u64": 2 ** 63 + 5, "float": 0.1, "none": None,
                   "true": True, "false": False, "str": "chair",
                   "long_str": "x" * 300, "unicode": "sofá",
                   "bytes": b"\x00\xff" * 40, "complex": complex(1.5, -2)},
    }


def test_reader_matches_flax_on_every_type(rng):
    tree = _every_type(rng)
    data = serialization.to_bytes(tree)
    _assert_same_tree(msgpack.restore(data),
                      serialization.msgpack_restore(data))


def test_reader_matches_flax_on_lists_and_long_containers(rng):
    """msgpack_serialize keeps lists (to_bytes turns them into dicts);
    more than 15 and 65535 entries take the 16- and 32-bit heads."""
    tree = {"list": [1, [2.5, None, "a"], np.arange(3, dtype=np.int32)],
            "wide": {f"k{i}": i for i in range(40)},
            "long": list(range(70000)), "big_bin": b"\x01" * 70000,
            "big_str": "y" * 70000}
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack.restore(data),
                      serialization.msgpack_restore(data))


def test_reader_reassembles_chunked_arrays(rng, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": rng.normal(size=(9, 13)).astype(np.float32),
            "nested": {"bf16": jnp.asarray(rng.normal(size=(50,)),
                                           jnp.bfloat16),
                       "i64": np.arange(33, dtype=np.int64)},
            "small": np.arange(4, dtype=np.int32)}
    data = serialization.to_bytes(tree)
    raw = msgpack.unpackb(data)
    assert "__msgpack_chunked_array__" in raw["big"]
    assert len(raw["big"]["chunks"]) > 1
    got = msgpack.restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert got["big"].shape == (9, 13)


def test_reader_raises_on_what_flax_does_not_write():
    with pytest.raises(ValueError, match="extension type 5"):
        msgpack.unpackb(b"\xd4\x05\x00")  # fixext 1, code 5
    with pytest.raises(ValueError, match="extension type -1"):
        msgpack.unpackb(b"\xd6\xff" + struct.pack(">I", 0))  # timestamp
    with pytest.raises(ValueError, match="type byte 0xc1"):
        msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.unpackb(b"\x92\x01")
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.unpackb(b"\x01\x02")


# -- the loaders --------------------------------------------------------------

@pytest.fixture(scope="module")
def lseg():
    jnet = JaxLSegNet(JaxLSegConfig.tiny16())
    variables = jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    return jnet, variables


def test_lseg_msgpack_forward_matches_jax_loader(tmp_path, lseg):
    jnet, variables = lseg
    path = tmp_path / "lseg.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    jvars = jax_load_lseg(str(path), jnet)
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    tnet.load_state_dict(load_lseg_params(str(path), tnet), strict=True)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jnet.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    # VLMap(lseg_ckpt=...) builds its map-creation network from the file
    mc = load_config().map_config
    mc.lseg_arch = "tiny16"
    apply, out_dim = VLMap(mc, lseg_ckpt=str(path),
                           device="cpu")._default_lseg()
    half = np.asarray(jax.jit(jnet.apply, static_argnames="upsample")(
        jvars, jnp.asarray(x), upsample=False))
    with torch.no_grad():
        got = apply(torch.from_numpy(x)).numpy()
    assert out_dim == half.shape[-1]
    np.testing.assert_allclose(got, half, rtol=5e-3, atol=5e-3)


def test_lseg_msgpack_missing_keys_raise_like_flax(tmp_path, lseg):
    """flax's from_bytes raises on a template key the file lacks and
    ignores keys the template does not have; so does the port."""
    jnet, variables = lseg
    params = dict(variables["params"])
    dropped = sorted(params)[0]
    del params[dropped]
    path = tmp_path / "partial.msgpack"
    path.write_bytes(serialization.to_bytes({"params": params}))
    with pytest.raises(ValueError):
        jax_load_lseg(str(path), jnet)
    tnet = LSegNet(LSegConfig.tiny16(), device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        load_lseg_params(str(path), tnet)

    extra = dict(variables["params"])
    extra["unused_head"] = {"kernel": np.ones((2, 2), np.float32)}
    path = tmp_path / "extra.msgpack"
    path.write_bytes(serialization.to_bytes({"params": extra}))
    jax_load_lseg(str(path), jnet)
    tnet.load_state_dict(load_lseg_params(str(path), tnet), strict=True)


TINY_CLIP = dict(embed_dim=24, image_size=32, patch_size=8, vision_width=32,
                 vision_layers=2, text_width=32, text_layers=2, text_heads=2)


def _write_clip(tmp_path):
    jcfg = JaxClipConfig(**TINY_CLIP)
    variables = jax.jit(JaxClip(jcfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, jcfg.context_length), jnp.int32),
        jnp.zeros((1, 32, 32, 3), jnp.float32))
    path = tmp_path / "clip.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    (tmp_path / "clip.config.json").write_text(
        json.dumps(jclip_port.config_to_jsonable(jcfg)))
    return path


def test_clip_msgpack_matches_jax_loader(tmp_path):
    path = _write_clip(tmp_path)
    jcfg, jvars = jclip_port.load_clip_checkpoint(str(path))
    cfg, sd = tclip_port.load_clip_checkpoint(str(path))
    assert cfg == ClipConfig(**TINY_CLIP)
    model = Clip(cfg, device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    tokens = default_tokenizer()(["a chair", "a sofa table"],
                                 cfg.context_length)
    img = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = JaxClip(jcfg)
    with torch.no_grad():
        for method, x in (("encode_text", tokens), ("encode_image", img)):
            want = jm.apply(jvars, jnp.asarray(x),
                            method=getattr(JaxClip, method))
            got = getattr(model, method)(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5)
    # the encoders of both packages from the file: template-mean text
    jenc = JaxClipEncoder.from_checkpoint(str(path))
    tenc = ClipEncoder.from_checkpoint(str(path), device="cpu")
    names = ["chair", "sofa table"]
    np.testing.assert_allclose(
        tenc.get_text_feats_multiple_templates(names),
        np.asarray(jenc.get_text_feats_multiple_templates(names)),
        atol=1e-5)


def test_clip_msgpack_needs_its_sidecar(tmp_path):
    path = _write_clip(tmp_path)
    (tmp_path / "clip.config.json").unlink()
    with pytest.raises(FileNotFoundError) as jerr:
        jclip_port.load_clip_checkpoint(str(path))
    with pytest.raises(FileNotFoundError) as terr:
        tclip_port.load_clip_checkpoint(str(path))
    assert str(terr.value) == str(jerr.value)


def test_audioclip_msgpack_matches_jax_loader(tmp_path):
    jcfg = JaxACConfig.tiny()
    variables = jac_port.port_audioclip_state_dict(
        synth_state_dict(jcfg, np.random.default_rng(7)), jcfg)
    path = tmp_path / "audioclip.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    (tmp_path / "audioclip.config.json").write_text(
        json.dumps(jac_port.config_to_jsonable(jcfg)))
    jcfg2, jvars = jac_port.load_audioclip_checkpoint_with_config(str(path))
    cfg, sd = tac_port.load_audioclip_checkpoint(str(path))
    assert cfg == AudioClipConfig.tiny()
    model = AudioClip(cfg, device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(8)
    audio = (rng.normal(size=(2, 2048)) * 8000).astype(np.float32)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    tokens = default_tokenizer()(["door knock"], cfg.context_length)
    jm = JaxAudioClip(jcfg2)

    def norm(z):
        z = np.asarray(z, np.float64)
        return z / np.linalg.norm(z, axis=-1, keepdims=True)

    with torch.no_grad():
        for method, x in (("encode_audio", audio), ("encode_image", img),
                          ("encode_text", tokens)):
            want = jm.apply(jvars, jnp.asarray(x),
                            method=getattr(JaxAudioClip, method))
            got = getattr(model, method)(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(norm(got), norm(want), atol=1e-4)
