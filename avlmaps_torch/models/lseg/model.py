"""LSeg: pixel-aligned CLIP features for open-vocabulary segmentation.

Counterpart of ``avlmaps_tpu/models/lseg/model.py`` (reference LSegEncNet,
avlmaps/lseg/modules/models/lseg_net.py:287-356): dense ViT backbone, DPT
decoder, a 1x1 head to the CLIP embedding width, per-pixel L2
normalisation times the fixed logit scale 1/0.07.  Images are NHWC in and
out, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from avlmaps_torch.models.lseg.dpt import DPTDecoder, conv
from avlmaps_torch.models.lseg.vit import DenseViT, DenseViTConfig
from avlmaps_torch.ops.resize import resize_bilinear_align_corners
from avlmaps_torch.utils.device import resolve_device

LOGIT_SCALE = float(np.exp(np.log(1.0 / 0.07)))  # = 1/0.07, fixed


@dataclasses.dataclass(frozen=True)
class LSegConfig:
    vit: DenseViTConfig = DenseViTConfig()
    features: int = 256
    reassemble_ch: Tuple[int, ...] = (256, 512, 1024, 1024)
    out_dim: int = 512
    dtype: torch.dtype = torch.float32

    @staticmethod
    def vitl16(dtype: torch.dtype = torch.float32) -> "LSegConfig":
        """The reference's clip_vitl16_384 backbone (hooks 5/11/17/23)."""
        return LSegConfig(vit=DenseViTConfig(dtype=dtype), dtype=dtype)

    @staticmethod
    def medium(dtype: torch.dtype = torch.float32) -> "LSegConfig":
        """Mid-scale config for parity tests: 12 layers, width 256."""
        return LSegConfig(
            vit=DenseViTConfig(patch_size=16, width=256, layers=12, heads=8,
                               hooks=(2, 5, 8, 11), pretrain_grid=12,
                               dtype=dtype),
            features=64, reassemble_ch=(64, 128, 256, 256), out_dim=96,
            dtype=dtype)

    @staticmethod
    def tiny(dtype: torch.dtype = torch.float32) -> "LSegConfig":
        """Small config for tests (patch 8: output is 2x input size)."""
        return LSegConfig(
            vit=DenseViTConfig(patch_size=8, width=32, layers=4, heads=2,
                               hooks=(0, 1, 2, 3), pretrain_grid=4,
                               dtype=dtype),
            features=16, reassemble_ch=(8, 16, 32, 32), out_dim=24,
            dtype=dtype)

    @staticmethod
    def tiny16(dtype: torch.dtype = torch.float32) -> "LSegConfig":
        """Small patch-16 config: output == input size, as the real model."""
        return LSegConfig(
            vit=DenseViTConfig(patch_size=16, width=32, layers=4, heads=2,
                               hooks=(0, 1, 2, 3), pretrain_grid=2,
                               dtype=dtype),
            features=16, reassemble_ch=(8, 16, 32, 32), out_dim=24,
            dtype=dtype)


class LSegNet(nn.Module):
    """Dense pixel-embedding network.

    ``forward(images, upsample=True)`` -> (B, H, W, out_dim) L2-normalised
    pixel features times the logit scale.  ``upsample=False`` returns them
    at the decoder's half resolution (the final 2x align-corners upsample is
    linear, so point samplers reproduce it; window.features_at_points), in
    bf16 for a bf16 model and f32 otherwise.

    Parameters are created on ``device`` (default ``"cuda"``; raises without
    a card) in f32; load weights with :func:`port.params_from_flax` or
    :func:`port.init_params`, then :func:`cast_params_for_inference`.
    """

    def __init__(self, cfg: LSegConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.backbone = DenseViT(cfg.vit)
            self.decoder = DPTDecoder(cfg.vit.width, cfg.reassemble_ch,
                                      cfg.features, cfg.dtype)
            self.head1 = nn.Conv2d(cfg.features, cfg.out_dim, 1)

    def forward(self, images: torch.Tensor,
                upsample: bool = True) -> torch.Tensor:
        cfg = self.cfg
        _, h, w, _ = images.shape
        gh, gw = h // cfg.vit.patch_size, w // cfg.vit.patch_size
        with record_function("lseg.vit"):
            taps = self.backbone(images)
        with record_function("lseg.dpt"):
            path = self.decoder(taps, gh, gw)
        with record_function("lseg.head"):
            feats = conv(path, self.head1, cfg.dtype).float()
            norm = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
            feats = feats / torch.clamp(norm, min=1e-12) * LOGIT_SCALE
            feats = feats.permute(0, 2, 3, 1).contiguous()  # NHWC
        if not upsample:
            if cfg.dtype == torch.bfloat16:
                return feats.to(torch.bfloat16)
            return feats
        ph, pw = feats.shape[1], feats.shape[2]
        return resize_bilinear_align_corners(feats, 2 * ph, 2 * pw)


def cast_params_for_inference(model: nn.Module,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> nn.Module:
    """Cast matrix-shaped params (ndim >= 2 with no size-1 axis: dense and
    conv kernels) to ``dtype`` once, in place, instead of on every forward.
    Vectors (LayerNorm scales, biases), broadcast params with a size-1 axis
    (pos-embed, cls token, 1x1 convs) and the DPT readout projections, whose
    cls term is computed in f32, stay f32 -- the JAX package's rule."""
    for name, p in model.named_parameters():
        if "readout" in name:
            continue
        if p.dim() >= 2 and min(p.shape) > 1:
            p.data = p.data.to(dtype)
    return model
