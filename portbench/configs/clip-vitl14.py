"""clip-vitl14: the area map's CLIP ViT-L/14 (f32): seeded weights, the
port's encoder built from them, and the image tower's operation count."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.bench import clip, roofline


def draw_clip(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return clip.draw(cfg["text"], seed, device)


def clip_encoder(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    return clip.encoder(cfg["text"], sd, device)


def image_flops(cfg: Dict) -> int:
    """One 224x224 image through the image tower and its projection."""
    v = cfg["text"]["vision"]
    g = v["image_size"] // v["patch_size"]
    return (roofline.vit_flops(1 + g * g, v["width"], v["layers"],
                               v["mlp_ratio"], v["patch_size"] ** 2 * 3)
            + roofline.linear_flops(1, v["width"], cfg["text"]["embed_dim"]))


def frame_flops(cfg: Dict) -> int:
    return image_flops(cfg)


def peak_flops(cfg: Dict) -> float:
    return roofline.PEAK_FLOPS[cfg["text"]["dtype"]]
