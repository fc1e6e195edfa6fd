"""Seeded weights drawn on the device in one call.

The leaves are laid out in the port's state-dict order; one ``randn``
fills a flat buffer with all of them and each leaf is a slice, shaped and
scaled by its rule.  Matrices (two or more axes of size > 1) become the
served dtype; the rest stays f32.  The reference receives the same
tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

Rule = Callable[[str, Tuple[int, ...]], Tuple[float, float]]


def draw(shapes: Dict[str, Tuple[int, ...]], rule: Rule, seed: int,
         device, matrix_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``rule(name, shape) -> (mean, std)`` for each leaf."""
    dev = torch.device(device)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=dev)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = rule(name, shape)
        leaf = flat[off:off + n].view(shape) * std + mean
        off += n
        matrix = len(shape) >= 2 and sorted(shape)[-2] > 1
        out[name] = leaf.to(matrix_dtype) if matrix else leaf.clone()
    del flat
    return out


def fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:])
