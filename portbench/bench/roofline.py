"""The card's published peaks and the operation and byte counts of the
measured models, from their shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.  A
roofline share is the least time the work needs, max(operations / peak
rate, bytes / peak bandwidth), over the device time it took; the work is
counted from the shapes, whatever kernels run it.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def linear_flops(m: int, k: int, n: int) -> int:
    """(m, k) @ (k, n): a multiply and an add each."""
    return 2 * m * k * n


def attention_flops(t: int, width: int) -> int:
    """Scores and the weighted sum over all heads of one sequence of
    ``t`` tokens: 2 * t^2 * width each."""
    return 4 * t * t * width


def conv2d_flops(h_out: int, w_out: int, cin: int, cout: int, kh: int,
                 kw: int) -> int:
    return 2 * h_out * w_out * cin * cout * kh * kw


def conv_transpose2d_flops(h_in: int, w_in: int, cin: int, cout: int,
                           k: int) -> int:
    """A stride-k, kernel-k transposed convolution: each input pixel
    writes a k x k block."""
    return 2 * h_in * w_in * cin * cout * k * k


def vit_flops(tokens: int, width: int, layers: int, mlp_ratio: int,
              patch_in: int) -> int:
    """One image through a pre-LN ViT: the patch projection of
    ``tokens - 1`` patches of ``patch_in`` values, then ``layers`` blocks
    of qkv (3W^2), attention output (W^2) and the MLP (2 * ratio * W^2)
    per token, plus attention."""
    per_token = (3 + 1 + 2 * mlp_ratio) * width * width
    block = 2 * tokens * per_token + attention_flops(tokens, width)
    return linear_flops(tokens - 1, patch_in, width) + layers * block


def vit_weight_bytes(width: int, layers: int, mlp_ratio: int,
                     dtype_bytes: int) -> int:
    """The block matrices, read once a forward."""
    return layers * (3 + 1 + 2 * mlp_ratio) * width * width * dtype_bytes


def dpt_head_flops(grid: int, width: int, reassemble: Sequence[int],
                   features: int, out_dim: int) -> int:
    """LSeg's DPT decoder and 1x1 head on a (grid x grid) token map: the
    readout projection (2W -> W, the cls half once per image), the
    reassemble 1x1 convs and resamples (4x and 2x transposed, none, a
    3x3 stride-2 conv), the 3x3 scratch convs, the four fusion blocks
    (two 3x3 convs per residual unit, the first block has one unit, a
    1x1 out conv after each 2x upsample) and the head at half input
    resolution."""
    g = grid
    f = 0
    sizes = [4 * g, 2 * g, g, (g + 1) // 2]  # each level's side
    for lvl, ch in enumerate(reassemble):
        f += linear_flops(g * g, width, width) + linear_flops(1, width, width)
        f += conv2d_flops(g, g, width, ch, 1, 1)
        if lvl == 0:
            f += conv_transpose2d_flops(g, g, ch, ch, 4)
        elif lvl == 1:
            f += conv_transpose2d_flops(g, g, ch, ch, 2)
        elif lvl == 3:
            f += conv2d_flops(sizes[3], sizes[3], ch, ch, 3, 3)
        f += conv2d_flops(sizes[lvl], sizes[lvl], ch, features, 3, 3)
    rcu = 2 * conv2d_flops(1, 1, features, features, 3, 3)  # per pixel
    for lvl in range(3, -1, -1):
        s = sizes[lvl]
        units = 1 if lvl == 3 else 2
        f += units * rcu * s * s
        f += conv2d_flops(2 * s, 2 * s, features, features, 1, 1)
    head = 2 * sizes[0]
    f += conv2d_flops(head, head, features, out_dim, 1, 1)
    return f


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
