"""Weight bridges for the port's CLIP, and seeded random weights.

- ``params_from_flax(tree)``: the JAX package's CLIP variables (a nested
  dict of arrays, ``{"params": {"text": ..., "visual": ...,
  "logit_scale": ...}}``, as ``Clip.init`` or ``port_clip_state_dict``
  produce) -> this package's ``state_dict``, which
  ``Clip.load_state_dict(..., strict=True)`` accepts.  ``block_<i>`` ->
  ``blocks.<i>``; Dense ``(in, out)`` -> Linear ``(out, in)``; the patch
  conv kernel ``(p, p, 3, W)`` -> ``(W, p*p*3)``; LayerNorm ``scale`` and
  Embed ``embedding`` -> ``weight``.
- ``load_clip_checkpoint(path)``: an OpenAI CLIP ``.pt`` (jit archive or
  plain state dict) -> ``(ClipConfig, state_dict)``, the config inferred
  from the tensor shapes as OpenAI's ``build_model`` does; or a
  pre-ported ``.msgpack`` (:func:`load_clip_msgpack`).
- ``init_params(cfg, generator)``: seeded weights at any width (real CLIP
  weights are not part of the repository).
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from avlmaps_torch.models.clip.model import Clip, ClipConfig

_BLOCK = re.compile(r"^block_(\d+)$")
_RENAME = {"scale": "weight", "embedding": "weight", "kernel": "weight"}
# OpenAI checkpoint scalars that are not parameters (build_model drops them)
_OPENAI_META = ("input_resolution", "context_length", "vocab_size")


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x, np.float32)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP variables -> this package's state_dict (f32
    CPU tensors)."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node, keys):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, keys + [str(k)])
            return
        arr = _np(node)
        leaf = keys[-1]
        if leaf == "kernel":
            arr = (arr.reshape(-1, arr.shape[-1]).T if arr.ndim == 4
                   else arr.T)
        path = []
        for k in keys[:-1]:
            m = _BLOCK.match(k)
            path += ["blocks", m.group(1)] if m else [k]
        name = ".".join(path + [_RENAME.get(leaf, leaf)])
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    walk(params, [])
    return out


def init_params(cfg: ClipConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``cfg`` as a state_dict on the
    generator's device: LayerNorm scale 1, biases 0, Linear weights
    N(0, 1/fan_in) (flax's lecun-normal scale), token and class embeddings
    and the projections N(0, 0.02^2), positional embeddings N(0, 0.01^2),
    logit scale log(1/0.07) -- the JAX package's initialisers."""
    shapes = Clip(cfg, device="meta").state_dict()
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            t = torch.tensor(float(np.log(1 / 0.07)), device=dev)
        elif leaf == "positional_embedding":
            t = normal(shape, 0.01)
        elif leaf in ("class_embedding", "text_projection", "proj") \
                or name.endswith("token_embedding.weight"):
            t = normal(shape, 0.02)
        elif leaf == "bias":
            t = torch.zeros(shape, device=dev)
        elif len(shape) == 1:  # LayerNorm scale
            t = torch.ones(shape, device=dev)
        else:
            t = normal(shape, 1.0 / math.sqrt(shape[1]))
        out[name] = t
    return out


def config_from_state_dict(sd: Mapping[str, Any]) -> ClipConfig:
    """Infer the CLIP variant's hyper-parameters from an OpenAI state
    dict's shapes (as OpenAI's build_model sizes the model)."""
    conv = sd["visual.conv1.weight"]
    vision_width, patch = int(conv.shape[0]), int(conv.shape[-1])
    n_pos = int(sd["visual.positional_embedding"].shape[0])
    text_width = int(sd["ln_final.weight"].shape[0])
    return ClipConfig(
        embed_dim=int(sd["text_projection"].shape[1]),
        image_size=int(round((n_pos - 1) ** 0.5)) * patch,
        patch_size=patch, vision_width=vision_width,
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith(
            "visual.transformer.resblocks.")}),
        text_width=text_width,
        text_layers=len({k.split(".")[2] for k in sd if k.startswith(
            "transformer.resblocks.")}),
        text_heads=max(1, text_width // 64),
        context_length=int(sd["positional_embedding"].shape[0]),
        vocab_size=int(sd["token_embedding.weight"].shape[0]))


def _block_name(rest: str) -> str:
    """OpenAI resblock parameter -> this package's block parameter."""
    return (rest.replace("attn.in_proj_weight", "attn.qkv.weight")
            .replace("attn.in_proj_bias", "attn.qkv.bias")
            .replace("attn.out_proj.", "attn.out.")
            .replace("mlp.c_fc.", "mlp_fc.")
            .replace("mlp.c_proj.", "mlp_proj."))


def state_dict_from_openai(sd: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state dict -> this package's state_dict (f32 CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key in _OPENAI_META:
            continue
        arr = _np(value)
        if key == "visual.conv1.weight":  # (W, 3, p, p) -> (W, p*p*3)
            name = "visual.patch_embed.weight"
            arr = arr.transpose(0, 2, 3, 1).reshape(arr.shape[0], -1)
        elif key.startswith("visual.transformer.resblocks."):
            i, rest = key[len("visual.transformer.resblocks."):].split(".",
                                                                      1)
            name = f"visual.blocks.{i}.{_block_name(rest)}"
        elif key.startswith("transformer.resblocks."):
            i, rest = key[len("transformer.resblocks."):].split(".", 1)
            name = f"text.blocks.{i}.{_block_name(rest)}"
        elif key.startswith("visual.") or key == "logit_scale":
            name = key
        else:  # token/positional embeddings, ln_final, text_projection
            name = f"text.{key}"
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def load_clip_checkpoint(path: str) -> Tuple[ClipConfig,
                                             Dict[str, torch.Tensor]]:
    """An OpenAI CLIP ``.pt`` (jit archive or plain state dict) or a
    pre-ported ``.msgpack`` -> ``(config, state_dict)`` for
    :class:`Clip`."""
    if str(path).endswith(".msgpack"):
        return load_clip_msgpack(path)
    try:
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(str(path), map_location="cpu")
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return config_from_state_dict(sd), state_dict_from_openai(sd)


def config_from_jsonable(d: Mapping[str, Any]) -> ClipConfig:
    """The ``.config.json`` sidecar's dict -> :class:`ClipConfig`."""
    return ClipConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items()})


def load_clip_msgpack(path: str) -> Tuple[ClipConfig,
                                          Dict[str, torch.Tensor]]:
    """A pre-ported ``clip.msgpack`` with its ``clip.config.json`` sidecar
    (tools/port_checkpoints.py writes both) -> ``(config, state_dict)``."""
    from avlmaps_torch.utils import msgpack

    p = Path(path)
    cfg_path = p.with_suffix(".config.json")
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"{cfg_path} not found — re-run tools/port_checkpoints.py "
            "(it writes the config sidecar next to the msgpack)")
    cfg = config_from_jsonable(json.loads(cfg_path.read_text()))
    return cfg, params_from_flax(msgpack.load(p))
