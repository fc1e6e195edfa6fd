"""Dense ViT backbone with multi-level feature taps.

Counterpart of ``avlmaps_tpu/models/lseg/vit.py``: timm's
``vit_large_patch16_384`` layout (patch projection with bias, cls token,
learned pos-embed resized bilinearly to the input grid, pre-LN blocks,
exact-erf GELU, LayerNorm eps 1e-6) returning the outputs of the hooked
blocks instead of registering hooks.

``DenseViTConfig.attn_impl`` picks a block's route, as in the JAX package:

- ``"fused"`` (default), bf16: the kernel wrappers of ops/fused_vit.py --
  ``ln_matmul`` (LN -> qkv), ``mha_oneshot_2d`` (attention on the fused
  qkv matrix), a plain ``F.linear`` for the attention projection plus the
  residual (the JAX package leaves that product to XLA too), then
  ``ln_mlp_residual``, or ``ln_matmul`` + ``gelu_matmul`` + a residual add
  in the model dtype when ``fused_vit.MLP_FUSE`` is False.
- ``"flash"`` / ``"splash"``, bf16: the unfused block of plain torch ops,
  with its (B, H, T, D) attention through ``mha_bhtd`` -- the port's K2 in
  place of JAX's bundled Pallas kernels.
- anything else (``"xla"``, ``"einsum"``), or a model that is not bf16:
  the unfused block of plain torch ops, as the JAX package runs it off
  the TPU.  An f32 model on CUDA runs here in full f32 (TF32 stays off).

On the CPU every route takes its plain versions: the wrappers' own for
"fused" (any dtype), ``mha_bhtd``'s for "flash"/"splash" (any dtype).  The
port needs neither the TPU's 901 -> 904 token pad nor its 2-head lane
packing; the attention wrappers still take ``t_real`` and mask keys at
or beyond it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.ops import fused_vit
from avlmaps_torch.ops.fused_vit import (_layer_norm_f32, gelu_matmul,
                                         ln_matmul, ln_mlp_residual,
                                         mha_bhtd, mha_oneshot_2d)
from avlmaps_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class DenseViTConfig:
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    pretrain_grid: int = 24  # 384 / 16: grid the pos-embed was trained at
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    attn_impl: str = "fused"  # "fused", "flash", "splash", "xla"


class ViTBlock(nn.Module):
    """Pre-LN transformer block (fused qkv, GELU MLP)."""

    def __init__(self, width: int, heads: int, mlp_ratio: int, ln_eps: float,
                 dtype: torch.dtype, attn_impl: str = "fused"):
        super().__init__()
        self.width, self.heads, self.ln_eps, self.dtype = (width, heads,
                                                           ln_eps, dtype)
        self.attn_impl = attn_impl
        self.norm1 = nn.LayerNorm(width, eps=ln_eps)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=ln_eps)
        self.mlp_fc = nn.Linear(width, mlp_ratio * width)
        self.mlp_proj = nn.Linear(mlp_ratio * width, width)

    def forward(self, x: torch.Tensor, t_real: int) -> torch.Tensor:
        cpu = x.device.type == "cpu"
        bf16 = self.dtype == torch.bfloat16
        if self.attn_impl == "fused" and (cpu or bf16):
            return self._fused(x, t_real)
        return self._unfused(x, t_real, kernel_attention=(
            self.attn_impl in ("flash", "splash") and (cpu or bf16)))

    def _fused(self, x: torch.Tensor, t_real: int) -> torch.Tensor:
        b, t, w = x.shape
        dt = self.dtype
        x2 = x.reshape(b * t, w).to(dt)
        qkv = ln_matmul(x2, self.norm1.weight, self.norm1.bias,
                        self.qkv.weight.to(dt), self.qkv.bias, eps=self.ln_eps)
        attn = mha_oneshot_2d(qkv, b, t, self.heads, t_real=t_real,
                              scale=1.0 / math.sqrt(w // self.heads))
        x2 = x2 + F.linear(attn, self.proj.weight.to(dt),
                           self.proj.bias.to(dt))
        if fused_vit.MLP_FUSE:
            x2 = ln_mlp_residual(x2, self.norm2.weight, self.norm2.bias,
                                 self.mlp_fc.weight.to(dt), self.mlp_fc.bias,
                                 self.mlp_proj.weight.to(dt),
                                 self.mlp_proj.bias, eps=self.ln_eps)
        else:
            # the fc output and the residual add round to the model dtype,
            # as the JAX package's unfused route does (K3 instead feeds
            # the GELU its f32 fc output)
            h = ln_matmul(x2, self.norm2.weight, self.norm2.bias,
                          self.mlp_fc.weight.to(dt), self.mlp_fc.bias,
                          eps=self.ln_eps)
            x2 = x2 + gelu_matmul(h, self.mlp_proj.weight.to(dt),
                                  self.mlp_proj.bias)
        return x2.reshape(b, t, w)

    def _unfused(self, x: torch.Tensor, t_real: int,
                 kernel_attention: bool) -> torch.Tensor:
        """The flax block's ops: LN statistics in f32 emitted in the model
        dtype, dense layers in the model dtype, exact-erf GELU.  Attention
        through ``mha_bhtd`` when ``kernel_attention``, else as the JAX
        package's einsum path (f32 logits and softmax, probabilities in
        the model dtype)."""
        b, t, w = x.shape
        dt = self.dtype
        hd = w // self.heads
        scale = 1.0 / math.sqrt(hd)

        def dense(layer, z):
            return F.linear(z, layer.weight.to(dt), layer.bias.to(dt))

        def norm(layer, z):
            return _layer_norm_f32(z, layer.weight, layer.bias,
                                   self.ln_eps).to(dt)

        x = x.to(dt)
        qkv = dense(self.qkv, norm(self.norm1, x))
        q, k, v = qkv.view(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        if kernel_attention:
            attn = mha_bhtd(q, k, v, scale=scale, t_real=t_real)
        else:
            logits = q.float() @ k.float().transpose(-1, -2) * scale
            if t_real < t:
                logits[..., t_real:] = float("-inf")
            probs = torch.softmax(logits, dim=-1).to(dt)
            attn = torch.matmul(probs, v)
        attn = attn.permute(0, 2, 1, 3).reshape(b, t, w)
        x = x + dense(self.proj, attn)
        h = F.gelu(dense(self.mlp_fc, norm(self.norm2, x)))
        return x + dense(self.mlp_proj, h)


class DenseViT(nn.Module):
    """ViT backbone returning the hooked blocks' outputs, (B, 1+gh*gw, W)
    each, in hook order (block outputs, before any final norm)."""

    def __init__(self, cfg: DenseViTConfig):
        super().__init__()
        self.cfg = cfg
        ps, w = cfg.patch_size, cfg.width
        # a Conv2d holds the weights; the forward applies them as one
        # matmul over the flattened (ps, ps, 3) patch vectors
        self.patch_embed = nn.Conv2d(3, w, ps, stride=ps)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, w))
        n_pre = cfg.pretrain_grid * cfg.pretrain_grid + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pre, w))
        # blocks above the last hook never reach the output
        n_blocks = min(cfg.layers, max(cfg.hooks) + 1)
        self.blocks = nn.ModuleList(
            ViTBlock(w, cfg.heads, cfg.mlp_ratio, cfg.ln_eps, cfg.dtype,
                     cfg.attn_impl)
            for _ in range(n_blocks))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """``images``: (B, H, W, 3) normalised, NHWC."""
        cfg = self.cfg
        dt = cfg.dtype
        b, h, w, cin = images.shape
        ps = cfg.patch_size
        gh, gw = h // ps, w // ps
        x = images.reshape(b, gh, ps, gw, ps, cin).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, ps * ps * cin).to(dt)
        kernel = self.patch_embed.weight.permute(0, 2, 3, 1).reshape(
            cfg.width, ps * ps * cin)
        x = F.linear(x, kernel.to(dt), self.patch_embed.bias.to(dt))
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, cfg.width), x],
                      dim=1)
        x = x + resize_pos_embed(self.pos_embed, cfg.pretrain_grid, gh,
                                 gw).to(dt)

        t_real = x.shape[1]
        taps: List[torch.Tensor] = []
        hook_set = set(cfg.hooks)
        for i, blk in enumerate(self.blocks):
            x = blk(x, t_real)
            if i in hook_set:
                taps.append(x)
        return taps


def resize_pos_embed(pos: torch.Tensor, grid_old: int, gh: int,
                     gw: int) -> torch.Tensor:
    """Resize the grid part of a (1, 1+g*g, D) pos-embed to (gh, gw) with
    the exact half-pixel resize, keeping the cls part (reference
    _resize_pos_embed, lseg_vit.py:149-163; align_corners=False)."""
    if gh == grid_old and gw == grid_old:
        return pos
    tok, grid = pos[:, :1], pos[:, 1:]
    d = grid.shape[-1]
    grid = grid.reshape(1, grid_old, grid_old, d)
    grid = resize_bilinear(grid, gh, gw).reshape(1, gh * gw, d)
    return torch.cat([tok, grid], dim=1)
