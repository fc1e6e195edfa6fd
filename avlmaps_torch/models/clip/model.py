"""CLIP text and vision encoders in PyTorch.

Counterpart of ``avlmaps_tpu/models/clip/model.py`` (OpenAI CLIP as the
reference consumes it through the pip ``clip`` package): fused qkv
projections, f32 attention logits with an additive causal mask of -inf,
pre-LN residual blocks with QuickGELU, f32 LayerNorms (eps 1e-5).  The
JAX package computes these towers with XLA, not Pallas, so they are plain
torch here, in f32 (``F.linear`` and ``matmul`` in f32 run full f32 on a
card unless TF32 is switched on, which the port never does).

Module and parameter names follow the flax modules (``blocks.<i>`` for
``block_<i>``, ``weight`` for flax's ``kernel``/``scale``/``embedding``),
so ``port.params_from_flax`` is a rename plus the Dense transpose.  The
vision patch embedding is a matmul over unfolded NHWC patches (flatten
order (row, col, channel), the flax conv kernel's), so no convolution,
and no cuDNN TF32, runs anywhere in CLIP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn

from avlmaps_torch.models.clip.tokenizer import CONTEXT_LENGTH, VOCAB_SIZE
from avlmaps_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    # text
    vocab_size: int = VOCAB_SIZE
    context_length: int = CONTEXT_LENGTH
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8

    @property
    def vision_heads(self) -> int:
        return max(1, self.vision_width // 64)


CLIP_VARIANTS = {
    "ViT-B/32": ClipConfig(embed_dim=512, image_size=224, patch_size=32,
                           vision_width=768, vision_layers=12),
    "ViT-B/16": ClipConfig(embed_dim=512, image_size=224, patch_size=16,
                           vision_width=768, vision_layers=12),
    "ViT-L/14": ClipConfig(embed_dim=768, image_size=224, patch_size=14,
                           vision_width=1024, vision_layers=24,
                           text_width=768, text_heads=12),
    "ViT-L/16": ClipConfig(embed_dim=768, image_size=384, patch_size=16,
                           vision_width=1024, vision_layers=24,
                           text_width=768, text_heads=12),
    # test/demo-scale variant: real tokenizer vocab, toy towers; embed_dim
    # 24 matches LSegConfig.tiny16's out_dim
    "tiny": ClipConfig(embed_dim=24, image_size=32, patch_size=8,
                       vision_width=32, vision_layers=2,
                       text_width=32, text_layers=2, text_heads=2),
}

CLIP_FEAT_DIMS = {
    "RN50": 1024, "RN101": 512, "RN50x4": 640, "RN50x16": 768,
    "RN50x64": 1024, "ViT-B/32": 512, "ViT-B/16": 512, "ViT-L/14": 768,
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """Multi-head attention with a fused qkv projection (CLIP layout)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        hd = self.width // self.heads
        q, k, v = self.qkv(x).split(self.width, dim=-1)
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2)
                   for z in (q, k, v))
        logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if mask is not None:
            logits = logits + mask
        out = torch.softmax(logits, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(b, t, self.width))


class ResidualBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP (CLIP layout)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class TextEncoder(nn.Module):
    """CLIP text transformer -> the projected feature at the EOT token."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.text_width))
        self.blocks = nn.ModuleList(
            [ResidualBlock(cfg.text_width, cfg.text_heads)
             for _ in range(cfg.text_layers)])
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.text_width, cfg.embed_dim))
        ctx = cfg.context_length
        self.register_buffer(
            "causal", torch.full((ctx, ctx), float("-inf")).triu_(1),
            persistent=False)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids: (B, T) ids, T <= context_length -> (B, embed_dim)
        f32.  Columns after every row's EOT may be cut: under the causal
        mask they never reach an EOT row."""
        ids = token_ids.long()
        t = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[:t]
        mask = self.causal[:t, :t]
        for blk in self.blocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        # EOT = the highest id in CLIP's vocabulary; argmax takes the first
        eot = ids.argmax(dim=1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection


class VisionTransformer(nn.Module):
    """CLIP ViT image encoder -> the projected class-token embedding."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(p * p * 3, w, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        n_pos = (cfg.image_size // p) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.empty(n_pos, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.blocks = nn.ModuleList(
            [ResidualBlock(w, cfg.vision_heads)
             for _ in range(cfg.vision_layers)])
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalised, H and W multiples of the
        patch -> (B, embed_dim)."""
        b, h, w, _ = images.shape
        p = self.cfg.patch_size
        gh, gw = h // p, w // p
        patches = images.float().reshape(b, gh, p, gw, p, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        x = self.patch_embed(patches)
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x[:, 0]) @ self.proj


class Clip(nn.Module):
    """Joint CLIP model: text and vision towers and the logit scale.
    Parameters are created on ``device`` (default ``"cuda"``; raises
    without a card; ``"meta"`` for shapes only)."""

    def __init__(self, cfg: ClipConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.text = TextEncoder(cfg)
            self.visual = VisionTransformer(cfg)
            self.logit_scale = nn.Parameter(
                torch.tensor(float(np.log(1 / 0.07))))

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text(token_ids)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def forward(self, token_ids: torch.Tensor,
                images: torch.Tensor) -> torch.Tensor:
        tf = self.encode_text(token_ids)
        vf = self.encode_image(images)
        tf = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
        vf = vf / torch.linalg.vector_norm(vf, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * vf @ tf.T


# CLIP's image preprocessing constants (OpenAI release)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images_uint8, size: int = 224) -> np.ndarray:
    """Resize (bicubic) + centre-crop + normalise a batch of HWC uint8
    images to CLIP's input distribution.  Host-side (PIL), as in the JAX
    package; returns (B, size, size, 3) f32.  ``ClipEncoder`` runs this on
    the CPU; on a CUDA device it runs ``ops/clip_resample.py``'s kernel
    instead, which gives the same bytes."""
    from PIL import Image

    out = np.zeros((len(images_uint8), size, size, 3), np.float32)
    for i, img in enumerate(images_uint8):
        if img.shape[0] == 0 or img.shape[1] == 0:
            img = np.zeros((1, 1, 3), np.uint8)
        pil = Image.fromarray(np.uint8(img))
        w, h = pil.size
        scale = size / min(w, h)
        pil = pil.resize((max(size, int(round(w * scale))),
                          max(size, int(round(h * scale)))),
                         Image.BICUBIC)
        w, h = pil.size
        left, top = (w - size) // 2, (h - size) // 2
        pil = pil.crop((left, top, left + size, top + size))
        out[i] = np.asarray(pil, np.float32) / 255.0
    return (out - IMAGE_MEAN) / IMAGE_STD
