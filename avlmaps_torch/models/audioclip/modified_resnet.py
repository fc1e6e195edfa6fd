"""CLIP's ModifiedResNet (RN50) image encoder, AudioCLIP's visual tower.

Counterpart of ``avlmaps_tpu/models/audioclip/modified_resnet.py``
(reference bundled CLIP, avlmaps/audioclip/model/clip/model.py: 3-conv
stem, stride by average pooling in the bottlenecks, attention-pool head).
Inference only (:class:`FrozenBatchNorm`); NCHW inside, with the OpenAI
module names (``downsample.0`` / ``downsample.1`` behind a parameter-free
``downsample.-1`` pool), so the checkpoint's ``visual.*`` keys load as
they are.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.models.audioclip.esresnet import FrozenBatchNorm


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    embed_dim: int = 1024
    heads: int = 32
    image_size: int = 224

    @staticmethod
    def tiny() -> "ModifiedResNetConfig":
        return ModifiedResNetConfig(layers=(1, 1, 1, 1), width=8,
                                    embed_dim=16, heads=2, image_size=32)


def _pool(stride: int) -> nn.Module:
    return nn.AvgPool2d(stride) if stride > 1 else nn.Identity()


class ClipBottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: every conv has stride 1, the stride
    is an average pool (reference clip/model.py Bottleneck)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.avgpool = _pool(stride)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (nn.Sequential(OrderedDict([
            ("-1", _pool(stride)),
            ("0", nn.Conv2d(inplanes, out_ch, 1, bias=False)),
            ("1", FrozenBatchNorm(out_ch))])) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(self.avgpool(h)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """Mean-token attention pooling (reference clip/model.py
    AttentionPool2d): prepend the spatial mean, add the positional
    embedding, one multi-head attention step with the mean as query."""

    def __init__(self, spatial: int, width: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spatial * spatial + 1, width))
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], 1)
        tokens = tokens + self.positional_embedding
        hd = c // self.heads

        def split(z):
            return z.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(tokens[:, :1]))
        k, v = split(self.k_proj(tokens)), split(self.v_proj(tokens))
        logits = (q @ k.transpose(-1, -2)) * (1.0 / np.sqrt(hd))
        out = torch.softmax(logits, dim=-1) @ v  # (B, heads, 1, hd)
        return self.c_proj(out.transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ModifiedResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm(w)
        self.avgpool = nn.AvgPool2d(2)
        in_ch = w
        for stage in range(4):
            planes = w * (2 ** stage)
            stride = 1 if stage == 0 else 2
            blocks = []
            for blk in range(cfg.layers[stage]):
                s = stride if blk == 0 else 1
                need_ds = blk == 0 and (s > 1 or in_ch != planes * 4)
                blocks.append(ClipBottleneck(in_ch, planes, s, need_ds))
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.image_size // 32, in_ch,
                                        cfg.heads, cfg.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalised, as the JAX package takes them
        -> (B, embed_dim)."""
        x = images.float().permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return self.attnpool(x)
