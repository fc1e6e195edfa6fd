"""LSeg (Li et al., ICLR 2022; github.com/isl-org/lang-seg,
``clip_vitl16_384``) as plain functions of a state dict.

The state dict has the benchmark's key layout (``backbone.*``,
``decoder.*``, ``head1.*``).  The forward follows the published model:
a timm ViT-L/16 (patch projection, cls token, the 24x24 position
embedding resized bilinearly to the input grid, pre-LN blocks with exact
GELU, LayerNorm eps 1e-6) tapped after blocks ``hooks``; DPT's readout
(``cat(tokens, cls) -> Linear -> GELU``), reassemble (1x1 conv, then a
4x or 2x transposed conv, none, or a 3x3 stride-2 conv), 3x3 scratch
convs, four fusion blocks (residual conv units, a 2x align-corners
upsample, a 1x1 conv), and the 1x1 head; the pixel embeddings are
L2-normalised and scaled by 1/0.07.  The inference BatchNorms of the
release are folded into the convs, so every conv carries a bias.

Departure from the release: the result stays at half the input
resolution; :func:`upsampled_at` evaluates the final 2x align-corners
upsample at the pixels asked for, which is the same number.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

LOGIT_SCALE = 1.0 / 0.07


def _linear(p: Precision, x, w, b=None):
    return F.linear(p.q(x), p.q(w), None if b is None else b.float())


def _conv(p: Precision, x, w, b=None, stride=1, padding=0):
    return F.conv2d(p.q(x), p.q(w), None if b is None else b.float(),
                    stride=stride, padding=padding)


def _conv_t(p: Precision, x, w, b, stride):
    return F.conv_transpose2d(p.q(x), p.q(w), b.float(), stride=stride)


def vit_taps(sd: Dict[str, torch.Tensor], images: torch.Tensor, spec: Dict,
             p: Precision) -> List[torch.Tensor]:
    """The hooked blocks' outputs, (B, 1 + gh * gw, W) each."""
    width, heads, ps = spec["width"], spec["heads"], spec["patch"]
    b, h, w, _ = images.shape
    gh, gw = h // ps, w // ps
    x = _conv(p, images.permute(0, 3, 1, 2), sd["backbone.patch_embed.weight"],
              sd["backbone.patch_embed.bias"], stride=ps)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["backbone.cls_token"].float().expand(b, 1, width)
    x = torch.cat([cls, x], dim=1)
    pos = sd["backbone.pos_embed"].float()
    g0 = spec["pretrain_grid"]
    if (gh, gw) != (g0, g0):
        grid = pos[:, 1:].reshape(1, g0, g0, width).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                             align_corners=False)
        pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1)
                         .reshape(1, gh * gw, width)], dim=1)
    x = x + pos
    t = x.shape[1]
    hd = width // heads
    taps = []
    for i in range(max(spec["hooks"]) + 1):
        k = f"backbone.blocks.{i}."
        y = F.layer_norm(x, (width,), sd[k + "norm1.weight"].float(),
                         sd[k + "norm1.bias"].float(), eps=1e-6)
        qkv = _linear(p, y, sd[k + "qkv.weight"], sd[k + "qkv.bias"])
        q, kk, v = qkv.view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(p.q(q) @ p.q(kk).transpose(-1, -2)
                            / math.sqrt(hd), dim=-1)
        y = (p.q(att) @ p.q(v)).transpose(1, 2).reshape(b, t, width)
        x = x + _linear(p, y, sd[k + "proj.weight"], sd[k + "proj.bias"])
        y = F.layer_norm(x, (width,), sd[k + "norm2.weight"].float(),
                         sd[k + "norm2.bias"].float(), eps=1e-6)
        y = F.gelu(_linear(p, y, sd[k + "mlp_fc.weight"],
                           sd[k + "mlp_fc.bias"]))
        x = x + _linear(p, y, sd[k + "mlp_proj.weight"],
                        sd[k + "mlp_proj.bias"])
        if i in spec["hooks"]:
            taps.append(x)
    return taps


def _rcu(sd, k: str, x, p: Precision):
    y = _conv(p, F.relu(x), sd[k + "conv1.weight"], sd[k + "conv1.bias"],
              padding=1)
    y = _conv(p, F.relu(y), sd[k + "conv2.weight"], sd[k + "conv2.bias"],
              padding=1)
    return x + y


def decoder(sd: Dict[str, torch.Tensor], taps, gh: int, gw: int,
            p: Precision) -> torch.Tensor:
    """DPT decoder and head -> (B, H/2, W/2, out_dim) f32 embeddings."""
    layers = []
    for lvl, tok in enumerate(taps):
        k = f"decoder.reassemble.{lvl}."
        b, _, width = tok.shape
        ro = torch.cat([tok[:, 1:], tok[:, :1].expand_as(tok[:, 1:])], -1)
        x = F.gelu(_linear(p, ro, sd[k + "readout.project.weight"],
                           sd[k + "readout.project.bias"]))
        x = x.transpose(1, 2).reshape(b, width, gh, gw)
        x = _conv(p, x, sd[k + "proj.weight"], sd[k + "proj.bias"])
        if lvl in (0, 1):
            x = _conv_t(p, x, sd[k + "resample.weight"],
                        sd[k + "resample.bias"], 4 if lvl == 0 else 2)
        elif lvl == 3:
            x = _conv(p, x, sd[k + "resample.weight"],
                      sd[k + "resample.bias"], stride=2, padding=1)
        layers.append(_conv(p, x, sd[f"decoder.scratch.{lvl}.weight"],
                            padding=1))
    path = None
    for lvl in (3, 2, 1, 0):
        k = f"decoder.refinenet.{lvl}."
        x = layers[lvl] if path is None else path + _rcu(sd, k + "rcu1.",
                                                         layers[lvl], p)
        x = _rcu(sd, k + "rcu2.", x, p)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        path = _conv(p, x, sd[k + "out_conv.weight"], sd[k + "out_conv.bias"])
    f = _conv(p, path, sd["head1.weight"], sd["head1.bias"])
    f = f / f.norm(dim=1, keepdim=True).clamp(min=1e-12) * LOGIT_SCALE
    return f.permute(0, 2, 3, 1).contiguous()


def half_res_embeddings(sd, images: torch.Tensor, spec: Dict,
                        p: Precision) -> torch.Tensor:
    """Normalised NHWC crops -> (B, H/2, W/2, D) f32."""
    ps = spec["patch"]
    with p.products():
        taps = vit_taps(sd, images, spec, p)
        return decoder(sd, taps, images.shape[1] // ps,
                       images.shape[2] // ps, p)


def upsampled_at(half: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """The 2x align-corners upsample of (H, W, D) ``half`` evaluated at
    full-resolution pixels (x, y), (N,) int each: source coordinate
    i * (H - 1) / (2H - 1), bilinear.  Returns (N, D)."""
    hh, ww, _ = half.shape
    sy = y.double() * ((hh - 1) / (2 * hh - 1))
    sx = x.double() * ((ww - 1) / (2 * ww - 1))
    y0 = sy.floor().clamp(0, hh - 2).long()
    x0 = sx.floor().clamp(0, ww - 2).long()
    ty = (sy - y0).float()[:, None]
    tx = (sx - x0).float()[:, None]
    return ((1 - ty) * (1 - tx) * half[y0, x0]
            + (1 - ty) * tx * half[y0, x0 + 1]
            + ty * (1 - tx) * half[y0 + 1, x0]
            + ty * tx * half[y0 + 1, x0 + 1])
