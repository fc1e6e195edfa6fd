"""Seeded weights for a CLIP configuration (``text`` of a configuration
file), drawn as CLIP initialises its leaves, and the port's encoder built
from them."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.bench import weights


def clip_config(t: Dict):
    from avlmaps_torch.models.clip.model import ClipConfig

    v = t["vision"]
    return ClipConfig(embed_dim=t["embed_dim"], image_size=v["image_size"],
                      patch_size=v["patch_size"], vision_width=v["width"],
                      vision_layers=v["layers"], vocab_size=t["vocab_size"],
                      context_length=t["context_length"],
                      text_width=t["width"], text_layers=t["layers"],
                      text_heads=t["heads"])


def rule(name: str, shape):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "positional_embedding":
        return 0.0, 0.01
    if leaf in ("class_embedding", "text_projection", "proj") \
            or name.endswith("token_embedding.weight"):
        return 0.0, 0.02
    if leaf == "bias":
        return 0.0, 0.02
    if len(shape) == 1:
        return 1.0, 0.02
    if name == "logit_scale":
        return 2.659260036932778, 0.0  # log(1 / 0.07)
    return 0.0, shape[1] ** -0.5


def draw(text: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """A whole CLIP (both towers: the encoder loads strictly) in f32."""
    from avlmaps_torch.models.clip.model import Clip

    shapes = {k: tuple(v.shape) for k, v in
              Clip(clip_config(text), device="meta").state_dict().items()}
    return weights.draw(shapes, rule, seed, device, torch.float32)


def encoder(text: Dict, sd: Dict[str, torch.Tensor], device):
    from avlmaps_torch.models.clip import ClipEncoder

    return ClipEncoder.from_config(clip_config(text), params=sd,
                                   device=device)
