"""ESResNeXt audio backbone: ResNeXt50-32x4d with stage attention over a
band-split log-power FBSP spectrogram.

Counterpart of ``avlmaps_tpu/models/audioclip/esresnet.py`` (reference
avlmaps/audioclip/model/esresnet/base.py, ResNetWithAttention :168-400 and
the _ESResNet spectrogram pipeline :557-640, and attention.py).
Inference only: BatchNorms use their stored statistics
(:class:`FrozenBatchNorm`).  NCHW, with the reference checkpoint's module
names (``layer1.0.conv2``, ``downsample.0``, ``att1.conv_depth``,
``fbsp.m``), so its ``audio.*`` keys load as they are.  The JAX package
computes this tower with XLA, not Pallas: it is plain torch here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.models.audioclip.fbsp import (blackmanharris_window,
                                                 fbsp_apply, fbsp_weights,
                                                 frame_signal, scale_signal)


class FrozenBatchNorm(nn.Module):
    """BatchNorm evaluated with its stored statistics, in the JAX
    package's form ``(x - mean) * (rsqrt(var + eps) * scale) + bias``;
    channels on dim 1."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


class Attention2d(nn.Module):
    """Depthwise + pointwise conv attention gate (reference
    attention.py:7-40): adaptive max pool to the gated stage's size,
    conv_depth (one group per channel), conv_point, BN, sigmoid.
    ``F.adaptive_max_pool2d``'s bins are the JAX package's
    ``adaptive_max_pool`` bins: [floor(i L / n), ceil((i + 1) L / n))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], padding: Tuple[int, int]):
        super().__init__()
        self.conv_depth = nn.Conv2d(in_channels, in_channels, kernel_size,
                                    padding=padding, groups=in_channels)
        self.conv_point = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]):
        x = F.adaptive_max_pool2d(x, out_hw)
        return torch.sigmoid(self.bn(self.conv_point(self.conv_depth(x))))


class Bottleneck(nn.Module):
    """ResNeXt bottleneck: conv1x1 -> grouped conv3x3 (strided) -> conv1x1,
    BN + ReLU (reference base.py:108-168)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 32, base_width: int = 4,
                 has_downsample: bool = False):
        super().__init__()
        width = int(planes * base_width / 64.0) * groups
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
            FrozenBatchNorm(out_ch)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


@dataclasses.dataclass(frozen=True)
class ESResNeXtConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    groups: int = 32
    width_per_group: int = 4
    num_classes: int = 1024  # = AudioCLIP's embed dim
    apply_attention: bool = True
    # spectrogram front end (reference audioclip.py:52-58)
    n_fft: int = 2048
    hop_length: int = 561
    win_length: int = 1654
    normalized: bool = True

    @staticmethod
    def tiny() -> "ESResNeXtConfig":
        return ESResNeXtConfig(layers=(1, 1, 1, 1), groups=4,
                               width_per_group=4, num_classes=16,
                               n_fft=64, hop_length=32, win_length=48)


class LinearFBSP(nn.Module):
    """The learned FBSP parameters (reference fbsp.py LinearFBSP): order
    ``m``, bandwidth ``fb`` and centre frequency ``fc`` per output bin."""

    def __init__(self, n_out: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(n_out))
        self.fb = nn.Parameter(torch.ones(n_out))
        self.fc = nn.Parameter(torch.arange(n_out, dtype=torch.float32))


# (in, out, kernel, padding) of the stage gates att1..att4 (reference
# base.py ResNetWithAttention); att5 gates the pooled features
_ATT_SPECS = ((64, 256, (3, 1), (1, 0)), (256, 512, (1, 5), (0, 2)),
              (512, 1024, (3, 1), (1, 0)), (1024, 2048, (1, 5), (0, 2)))


class ESResNeXtFBSP(nn.Module):
    """The audio tower: int16-scaled waveform (B, T) -> (B, num_classes).

    Frame -> pad to n_fft -> FBSP complex filterbank -> band split into 3
    channels -> 10 log10 power -> ResNeXt with attention -> global pool
    -> fc (reference _ESResNetFBSP.spectrogram, fbsp.py:140-160, and
    _ESResNet._forward_*, base.py:599-640)."""

    def __init__(self, cfg: ESResNeXtConfig):
        super().__init__()
        self.cfg = cfg
        self.fbsp = LinearFBSP(cfg.n_fft // 2 + 1)
        self.register_buffer("window", torch.tensor(
            blackmanharris_window(cfg.win_length), dtype=torch.float32),
            persistent=False)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for blk in range(cfg.layers[stage]):
                s = stride if blk == 0 else 1
                need_ds = blk == 0 and (s != 1 or in_ch != planes * 4)
                blocks.append(Bottleneck(in_ch, planes, s, cfg.groups,
                                         cfg.width_per_group, need_ds))
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        if cfg.apply_attention:
            for stage, (a_in, a_out, ks, pad) in enumerate(_ATT_SPECS):
                setattr(self, f"att{stage + 1}",
                        Attention2d(a_in, a_out, ks, pad))
            self.att5 = Attention2d(in_ch, in_ch, (3, 5), (1, 2))
        self.fc = nn.Linear(in_ch, cfg.num_classes)

    def filterbank(self) -> torch.Tensor:
        """The (out, n_fft, 2) FBSP kernels on the parameters' device.  They
        depend on the parameters alone, so they are materialised once per
        change of (m, fb, fc), on the host in f32, and uploaded: the card
        and the CPU then hold the same kernels to the bit (the phase
        fc * t reaches ~3.2e3 rad, where one ulp of cos differs between
        devices)."""
        p = self.fbsp
        key = (p.m.device, p.m._version, p.fb._version, p.fc._version)
        if getattr(self, "_filterbank_key", None) != key:
            w = fbsp_weights(p.m.detach().cpu(), p.fb.detach().cpu(),
                             p.fc.detach().cpu(), self.cfg.n_fft,
                             normalized=self.cfg.normalized)
            self._filterbank = w.to(p.m.device)
            self._filterbank_key = key
        return self._filterbank

    def spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, 3, n_bins // 3, frames) power in dB."""
        cfg = self.cfg
        x = scale_signal(audio.float())
        frames = frame_signal(x, cfg.win_length, cfg.hop_length,
                              self.window)
        if cfg.n_fft > cfg.win_length:
            pad = cfg.n_fft - cfg.win_length
            frames = F.pad(frames, (pad // 2, pad - pad // 2))
        # (B, F, n_out, 2) -> (B, n_out, F, 2)
        spec = fbsp_apply(frames, self.filterbank()).transpose(1, 2)
        per_band = spec.shape[1] // 3
        spec = spec[:, :3 * per_band]
        pow_spec = spec[..., 0] ** 2 + spec[..., 1] ** 2
        pow_spec = torch.where(pow_spec > 0.0, pow_spec,
                               torch.full_like(pow_spec, 1e-18))
        x_db = 10.0 * torch.log10(pow_spec)
        return x_db.reshape(x_db.shape[0], 3, per_band, -1)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.spectrogram(audio)
        x = F.relu(self.bn1(self.conv1(x)))
        # MaxPool2d pads with -inf, as flax's max_pool does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, 5):
            x_att = x
            x = getattr(self, f"layer{stage}")(x)
            if self.cfg.apply_attention:
                x = x * getattr(self, f"att{stage}")(x_att, x.shape[-2:])
        # reduction (reference _forward_reduction, base.py:369-381)
        pooled = x.mean(dim=(2, 3), keepdim=True)
        if self.cfg.apply_attention:
            pooled = pooled * self.att5(x, (1, 1))
        return self.fc(pooled.flatten(1))
