"""SuperGlue's masked multi-head attention over strided heads, in f32.

``masked_attention(q, k, v, valid, heads)`` is the attention of one
attentional propagation (``models/superglue/model.py``'s
``Propagation``): q (B, N, D), k and v (B, M, D) in the projections' own
layout, where channel c belongs to head ``c % heads`` (the torch original
views (b, d, n) as (b, head_dim, heads, n)), and a (B, M) bool key mask.
Logits are ``q_h . k_h / sqrt(head_dim)``; a padded key's logit is
REPLACED by ``NEG``, so a query whose keys are all padded averages all M
values, as a softmax over equal logits does; the output is the softmax
over the keys times v, (B, N, D) in the same layout.

q, k, v and the mask share one device.  A tensor on the CPU takes the
plain version, :func:`masked_attention_ref` (the einsums and the softmax
the model ran before the kernel existed); a CUDA tensor launches the kernel of ``csrc/superglue_attention.cu`` (four
heads of 8 to 64 channels, f32 FFMA with online softmax: no logit
reaches device memory) or raises; a tensor on another device (``meta``)
meets the kernel's checks first, so they are testable without a card.
``masked_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from avlmaps_torch.kernels import build
from avlmaps_torch.kernels.build import require
from avlmaps_torch.ops.sinkhorn import NEG

KERNEL_HEADS = 4
KERNEL_HEAD_DIMS = tuple(range(8, 65, 8))


def masked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version: the (B, heads, N, M) logits, the mask, a softmax and
    the weighted sum, as torch ops."""
    b, n, d = q.shape
    m = k.shape[1]
    hd = d // heads
    # strided heads: (b, n, d) -> (b, n, hd, h), channel c -> head c % h
    q = q.reshape(b, n, hd, heads)
    k = k.reshape(b, m, hd, heads)
    v = v.reshape(b, m, hd, heads)
    logits = torch.einsum("bqdh,bkdh->bhqk", q, k) / (hd ** 0.5)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG))
    prob = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkdh->bqdh", prob, v).reshape(b, n, d)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, D) queries, (B, M, D) keys and values, (B, M) bool key mask,
    ``heads`` strided heads -> the (B, N, D) attention output."""
    require(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
            "masked_attention: need (B, N, D) q and (B, M, D) k, v, got {}, "
            "{}, {}", tuple(q.shape), tuple(k.shape), tuple(v.shape))
    b, n, d = q.shape
    m = k.shape[1]
    require(tuple(k.shape) == (b, m, d) and tuple(v.shape) == (b, m, d),
            "masked_attention: k {} and v {} do not fit q {}",
            tuple(k.shape), tuple(v.shape), tuple(q.shape))
    require(tuple(valid.shape) == (b, m) and valid.dtype == torch.bool,
            "masked_attention: need a ({}, {}) bool key mask, got {} {}",
            b, m, valid.dtype, tuple(valid.shape))
    require(heads >= 1 and d % heads == 0,
            "masked_attention: {} channels do not split into {} heads", d,
            heads)
    require(k.device == v.device == valid.device == q.device,
            "masked_attention: q on {}, k on {}, v on {}, valid on {}: need "
            "one device", q.device, k.device, v.device, valid.device)
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, valid, heads)
    hd = d // heads
    require(heads == KERNEL_HEADS and hd in KERNEL_HEAD_DIMS,
            "masked_attention: the kernel takes 4 heads of 8 to 64 channels "
            "in steps of 8, got {} heads of {}", heads, hd)
    require(q.dtype == k.dtype == v.dtype == torch.float32,
            "masked_attention: need f32 q, k, v, got {}, {}, {}", q.dtype,
            k.dtype, v.dtype)
    require(min(b, n, m) >= 1 and b < 65536 and max(n, m) < 1 << 24,
            "masked_attention: shapes out of the kernel's range: B {}, N {}, "
            "M {}", b, n, m)
    require(q.is_cuda, "masked_attention: unsupported device {}", q.device)
    q, k, v, valid = (t.contiguous() for t in (q, k, v, valid))
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "masked_attention: q, k, v must start on 16 bytes")
    out = torch.empty_like(q)
    build.check(build.load("superglue_attention").avl_superglue_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, n, m, hd, 1.0 / hd ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream),
        "masked_attention")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
