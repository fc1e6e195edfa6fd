"""Binary morphology and Gaussian blur on 2D tensors.

Counterpart of ``avlmaps_tpu/ops/morphology.py`` (the reference uses
scipy.ndimage's binary_dilation/erosion/closing and gaussian_filter on
obstacle maps, avlmaps/map/map.py:169-181, avlmaps/map/vlmap.py:167-171).
The functions run on the input tensor's device.  The blur is a weighted
sum of shifted slices in f32 (no convolution, so no cuDNN TF32 on a card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _max3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max over a 2D f32 map; the border reads nothing outside (the
    -inf init of XLA's reduce_window, max_pool2d's padding)."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def binary_dilation(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3x3 full-structure binary dilation, ``iterations`` times
    (scipy.ndimage.binary_dilation with structure=ones((3, 3)))."""
    x = mask.float()
    for _ in range(iterations):
        x = _max3x3(x)
    return x > 0.5


def binary_erosion(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3x3 full-structure binary erosion; the border erodes, matching
    scipy's default zero padding."""
    x = mask.float()
    for _ in range(iterations):
        x = -_max3x3(-x)
        x[0, :] = 0.0
        x[-1, :] = 0.0
        x[:, 0] = 0.0
        x[:, -1] = 0.0
    return x > 0.5


def binary_closing(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Dilate N times, then erode N times
    (scipy.ndimage.binary_closing(iterations=N), reference
    VLMap.get_pos, vlmap.py:168)."""
    return binary_erosion(binary_dilation(mask, iterations), iterations)


def _gaussian_kernel1d(sigma: float, truncate: float) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of ``np.pad(mode="symmetric")`` by ``r`` on each side of an
    axis of length ``n`` (the edge sample repeats; any r)."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _blur_axis(x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    r = (k.shape[0] - 1) // 2
    n = x.shape[axis]
    xp = x.index_select(axis, _symmetric_index(n, r, x.device))
    out = torch.zeros_like(x)
    for j in range(k.shape[0]):
        out = out + xp.narrow(axis, j, n) * k[j]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0,
                  truncate: float = 3.0) -> torch.Tensor:
    """Separable Gaussian blur with scipy.ndimage.gaussian_filter's kernel
    (the reference's truncate=3, map.py:173) and its 'reflect' boundary
    (= np.pad 'symmetric')."""
    x = img.float()
    k = torch.from_numpy(_gaussian_kernel1d(sigma, truncate)).to(x.device)
    return _blur_axis(_blur_axis(x, k, 0), k, 1)
