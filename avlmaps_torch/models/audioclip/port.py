"""Weight bridges for the port's AudioCLIP, and seeded random weights.

- ``params_from_flax(tree)``: the JAX package's AudioCLIP variables
  (``{"params": {"text", "audio", "visual", "logit_scale*"}}`` as numpy
  or JAX arrays) -> this package's ``AudioClip`` state_dict.  Conv
  kernels ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``, Dense ``(in,
  out)`` -> ``(out, in)``, ``layer<s>_<b>`` -> ``layer<s>.<b>``,
  ``downsample_conv``/``_bn`` -> ``downsample.0``/``.1``, BatchNorm
  ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
  ``running_var``; the text tower through the CLIP bridge.
- ``load_audioclip_checkpoint(path)``: AudioCLIP-Partial-Training ``.pt``
  -> ``(AudioClipConfig, state_dict)``.  The audio and image towers carry
  the checkpoint's own names (``audio.*``, ``visual.*``), so their keys
  load as they are; the top-level CLIP text keys take the CLIP bridge's
  renames -- the key map of the JAX package's ``port.py:123-203``; or a
  pre-ported ``.msgpack`` (:func:`load_audioclip_msgpack`).
- ``init_params(cfg, generator)``: seeded weights at any width.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from avlmaps_torch.models.audioclip.audioclip import AudioClip, AudioClipConfig
from avlmaps_torch.models.audioclip.esresnet import ESResNeXtConfig
from avlmaps_torch.models.audioclip.modified_resnet import ModifiedResNetConfig
from avlmaps_torch.models.clip import port as clip_port

_LAYER = re.compile(r"^layer(\d)_(\d+)$")
_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var", "downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1", "fbsp_m": "fbsp.m",
           "fbsp_fb": "fbsp.fb", "fbsp_fc": "fbsp.fc"}
_SCALES = ("logit_scale", "logit_scale_ai", "logit_scale_at")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's AudioCLIP variables -> this package's state_dict
    (f32 CPU tensors)."""
    params = tree["params"] if "params" in tree else tree
    out = {f"text.{k}": v for k, v in clip_port.params_from_flax(
        params["text"]).items()}

    def walk(node, keys):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, keys + [str(k)])
            return
        arr = clip_port._np(node)
        if keys[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        path = []
        for k in keys:
            m = _LAYER.match(k)
            path.append(f"layer{m.group(1)}.{m.group(2)}" if m
                        else _RENAME.get(k, k))
        out[".".join(path)] = _tensor(arr)

    walk(params["audio"], ["audio"])
    walk(params["visual"], ["visual"])
    for name in _SCALES:
        out[name] = _tensor(clip_port._np(params[name]).reshape(()))
    return out


def init_params(cfg: AudioClipConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``cfg`` as a state_dict on the
    generator's device, with the JAX package's initialisers: conv and
    Linear weights N(0, 1/fan_in), biases 0, norm scales and variances 1,
    means 0, the FBSP parameters (m, fb, fc) = (0, 1, bin index), the
    positional embeddings N(0, 0.01^2), token embedding and text
    projection N(0, 0.02^2), the logit scales log(1/0.07) and log(100)."""
    shapes = AudioClip(cfg, device="meta").state_dict()
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name in _SCALES:
            t = torch.tensor(float(np.log(1 / 0.07) if name == "logit_scale"
                                   else np.log(100.0)), device=dev)
        elif name.endswith("fbsp.fc"):
            t = torch.arange(shape[0], dtype=torch.float32, device=dev)
        elif name.endswith("fbsp.m") or leaf in ("bias", "running_mean"):
            t = torch.zeros(shape, device=dev)
        elif leaf == "positional_embedding":
            t = normal(shape, 0.01)
        elif leaf == "text_projection" \
                or name.endswith("token_embedding.weight"):
            t = normal(shape, 0.02)
        elif len(shape) == 1:  # norm scales, running_var, fbsp.fb
            t = torch.ones(shape, device=dev)
        else:
            t = normal(shape, 1.0 / math.sqrt(math.prod(shape[1:])))
        out[name] = t
    return out


def config_from_state_dict(sd: Mapping[str, Any]) -> AudioClipConfig:
    """The AudioCLIP variant from a checkpoint's shapes: block counts of
    ``transformer.resblocks`` / ``audio.layer<s>`` / ``visual.layer<s>``
    and the projection widths (the JAX package's rules)."""
    def shape(key):
        return tuple(sd[key].shape)

    def stage_counts(prefix):
        return tuple(len({k.split(".")[2] for k in sd
                          if k.startswith(f"{prefix}.layer{stage}.")})
                     for stage in range(1, 5))

    text_width = shape("ln_final.weight")[0]
    embed_dim = shape("text_projection")[1]
    base = AudioClipConfig()
    n_out = shape("audio.fbsp.m")[0]
    # the grouped conv's width gives groups * width_per_group
    w2 = shape("audio.layer1.0.conv2.weight")
    groups = w2[0] // w2[1]
    audio = dataclasses.replace(
        base.audio, layers=stage_counts("audio"), num_classes=embed_dim,
        n_fft=2 * (n_out - 1), groups=groups,
        width_per_group=w2[0] * 64 // (64 * groups))
    n_pos = shape("visual.attnpool.positional_embedding")[0]
    c_final = shape("visual.attnpool.k_proj.weight")[0]
    # OpenAI's rule: attnpool heads = width * 32 // 64 = c_final // 64
    vision = dataclasses.replace(
        base.vision, layers=stage_counts("visual"),
        width=shape("visual.conv3.weight")[0], embed_dim=embed_dim,
        heads=max(1, c_final // 64),
        image_size=int(round((n_pos - 1) ** 0.5)) * 32)
    return AudioClipConfig(
        embed_dim=embed_dim, text_width=text_width,
        text_layers=len({k.split(".")[2] for k in sd
                         if k.startswith("transformer.resblocks.")}),
        text_heads=max(1, text_width // 64),
        context_length=shape("positional_embedding")[0],
        vocab_size=shape("token_embedding.weight")[0],
        audio=audio, vision=vision)


def state_dict_from_reference(sd: Mapping[str, Any], cfg: AudioClipConfig
                              ) -> Dict[str, torch.Tensor]:
    """A reference AudioCLIP state dict -> this package's state_dict for
    ``cfg`` (f32 CPU).  Keys the model does not hold (BatchNorm's
    ``num_batches_tracked``, buffers the reference keeps) are dropped, as
    the reference's ``strict=False`` load drops them; a key the model
    needs and the checkpoint lacks raises ``KeyError``."""
    towers = ("audio.", "visual.")
    text = clip_port.state_dict_from_openai(
        {k: v for k, v in sd.items()
         if not k.startswith(towers) and k not in _SCALES})
    wanted = AudioClip(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for name in wanted:
        if name.startswith("text."):
            src = text.get(name)
        else:
            src = sd.get(name)
            src = None if src is None else _tensor(
                clip_port._np(src).reshape(wanted[name].shape))
        if src is None:
            missing.append(name)
        else:
            out[name] = src
    if missing:
        raise KeyError(f"AudioCLIP checkpoint lacks {len(missing)} keys, "
                       f"e.g. {missing[:5]}")
    return out


def load_audioclip_checkpoint(path: str) -> Tuple[AudioClipConfig,
                                                  Dict[str, torch.Tensor]]:
    """AudioCLIP-Partial-Training ``.pt`` -> ``(config, state_dict)`` for
    :class:`AudioClipEncoder`.  The config is read off the shapes, which
    do not hold the spectrogram's window and hop: those stay the
    full-width model's.  A pre-ported ``.msgpack`` goes to
    :func:`load_audioclip_msgpack`."""
    if str(path).endswith(".msgpack"):
        return load_audioclip_msgpack(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    cfg = config_from_state_dict(sd)
    return cfg, state_dict_from_reference(sd, cfg)


def config_from_jsonable(d: Mapping[str, Any]) -> AudioClipConfig:
    """The ``.config.json`` sidecar's nested dict -> AudioClipConfig."""
    def tup(v):
        return tuple(v) if isinstance(v, list) else v

    audio = ESResNeXtConfig(**{k: tup(v) for k, v in d["audio"].items()})
    vision = ModifiedResNetConfig(**{k: tup(v)
                                     for k, v in d["vision"].items()})
    rest = {k: tup(v) for k, v in d.items() if k not in ("audio", "vision")}
    return AudioClipConfig(audio=audio, vision=vision, **rest)


def load_audioclip_msgpack(path: str) -> Tuple[AudioClipConfig,
                                               Dict[str, torch.Tensor]]:
    """A pre-ported ``audioclip.msgpack`` with its
    ``audioclip.config.json`` sidecar (tools/port_checkpoints.py writes
    both) -> ``(config, state_dict)``."""
    from avlmaps_torch.utils import msgpack

    p = Path(path)
    cfg_path = p.with_suffix(".config.json")
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"{cfg_path} not found — re-run tools/port_checkpoints.py "
            "(it writes the config sidecar next to the msgpack)")
    cfg = config_from_jsonable(json.loads(cfg_path.read_text()))
    return cfg, params_from_flax(msgpack.load(p))
