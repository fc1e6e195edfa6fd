"""DPT decoder: readout projection, reassemble pyramid, fusion refinement.

Counterpart of ``avlmaps_tpu/models/lseg/dpt.py`` (reference plumbing:
avlmaps/lseg/modules/models/lseg_vit.py:426-535, lseg_blocks.py:60-360).
Runs NCHW internally; the reference's inference BatchNorms are folded into
the preceding convs, so every conv is conv + bias.  Convolutions,
including the transposed ones, are plain ``torch.nn.functional`` calls in
the model dtype, as the JAX package leaves them to XLA.

The fourth reassemble stage's 3x3 stride-2 conv runs one image at a time
(:func:`conv_per_image`): on a card, cuDNN's result for an image there
depends in the last bits on how many images share the launch and on the
image's place among them, which made a crop's features depend on the
forward's batch (a sharded build against a single-device one).  With
that one call per image, the decoder's output for a crop is the same in
any batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.ops.resize import resize_bilinear_align_corners_nchw


def conv(x: torch.Tensor, m: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    """``m`` applied in dtype ``dt`` (weights cast per call, as flax)."""
    bias = m.bias.to(dt) if m.bias is not None else None
    return F.conv2d(x.to(dt), m.weight.to(dt), bias, stride=m.stride,
                    padding=m.padding)


def conv_per_image(x: torch.Tensor, m: nn.Conv2d,
                   dt: torch.dtype) -> torch.Tensor:
    """:func:`conv` on each image of ``x`` alone."""
    if x.shape[0] == 1:
        return conv(x, m, dt)
    return torch.cat([conv(c, m, dt) for c in x.split(1)])


class ProjectReadout(nn.Module):
    """cat(tokens, cls) -> Linear(2D -> D) -> GELU (reference
    ProjectReadout, lseg_vit.py:79-90), with the concat applied
    algebraically: t @ W[:, :D]^T + (cls @ W[:, D:]^T + b), the cls term in
    f32."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.project = nn.Linear(2 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        dt = self.dtype
        wgt = self.project.weight
        corr = F.linear(x[:, :1].float(), wgt[:, d:].float(),
                        self.project.bias.float()).to(dt)
        h = F.linear(x[:, 1:].to(dt), wgt[:, :d].to(dt)) + corr
        return F.gelu(h)


class Reassemble(nn.Module):
    """Tokens -> NCHW map at one pyramid scale.

    level 0: 1x1 conv + 4x4/4 transposed conv (1/4 scale); level 1: 1x1
    conv + 2x2/2 transposed conv (1/8); level 2: 1x1 conv (1/16); level 3:
    1x1 conv + 3x3/2 strided conv (1/32)."""

    def __init__(self, level: int, vit_width: int, out_ch: int,
                 dtype: torch.dtype):
        super().__init__()
        self.level, self.vit_width, self.dtype = level, vit_width, dtype
        self.readout = ProjectReadout(vit_width, dtype)
        self.proj = nn.Conv2d(vit_width, out_ch, 1)
        self.resample: Optional[nn.Module] = None
        if level in (0, 1):
            k = 4 if level == 0 else 2
            self.resample = nn.ConvTranspose2d(out_ch, out_ch, k, stride=k)
        elif level == 3:
            self.resample = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1)

    def forward(self, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        dt = self.dtype
        x = self.readout(tokens)
        b = x.shape[0]
        x = x.reshape(b, gh, gw, self.vit_width).permute(0, 3, 1, 2)
        x = conv(x, self.proj, dt)
        if self.level in (0, 1):
            m = self.resample
            x = F.conv_transpose2d(x, m.weight.to(dt), m.bias.to(dt),
                                   stride=m.stride)
        elif self.level == 3:
            x = conv_per_image(x, self.resample, dt)
        return x


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3 -> +x (BatchNorms folded)."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(F.relu(x), self.conv1, self.dtype)
        h = conv(F.relu(h), self.conv2, self.dtype)
        return x + h


class FeatureFusionBlock(nn.Module):
    """Merge the skip, refine, 2x align-corners upsample, 1x1 out conv
    (reference FeatureFusionBlock_custom, lseg_blocks.py:292-360)."""

    def __init__(self, features: int, dtype: torch.dtype, has_skip: bool):
        super().__init__()
        self.dtype = dtype
        self.rcu1 = ResidualConvUnit(features, dtype) if has_skip else None
        self.rcu2 = ResidualConvUnit(features, dtype)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        h, w = x.shape[2], x.shape[3]
        x = resize_bilinear_align_corners_nchw(x, 2 * h, 2 * w)
        return conv(x, self.out_conv, self.dtype)


class DPTDecoder(nn.Module):
    """Reassemble the 4 taps, 3x3 scratch convs, 4 fusion stages; returns
    the fused NCHW map at 1/2 input resolution."""

    def __init__(self, vit_width: int = 1024,
                 reassemble_ch: Tuple[int, ...] = (256, 512, 1024, 1024),
                 features: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.reassemble = nn.ModuleList(
            Reassemble(i, vit_width, reassemble_ch[i], dtype)
            for i in range(4))
        self.scratch = nn.ModuleList(
            nn.Conv2d(reassemble_ch[i], features, 3, padding=1, bias=False)
            for i in range(4))
        # refinenet[0..3] = the reference's refinenet1..4; refinenet4 takes
        # one input, so it has no rcu1
        self.refinenet = nn.ModuleList(
            FeatureFusionBlock(features, dtype, has_skip=i != 3)
            for i in range(4))

    def forward(self, taps: Sequence[torch.Tensor], gh: int,
                gw: int) -> torch.Tensor:
        layers = [conv(self.reassemble[i](t, gh, gw), self.scratch[i],
                       self.dtype) for i, t in enumerate(taps)]
        path = self.refinenet[3](layers[3])
        path = self.refinenet[2](path, layers[2])
        path = self.refinenet[1](path, layers[1])
        return self.refinenet[0](path, layers[0])
