"""JAX's threefry2x32 random bits in plain torch integer ops.

The device-sampled map build draws its pixels as the JAX package does,
``jax.random.randint(fold_in(PRNGKey(seed), frame_id), (n,), 0, span)``
with ``jax_threefry_partitionable`` on (the default since JAX 0.5).
Threefry is fully specified, so the same draws come out here, bit for bit,
on the CPU and on a card: uint32 words are held in int64 tensors and
masked to 32 bits after every add and shift.  Mirrors
``jax/_src/prng.py`` (``threefry2x32``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py::_randint``.

A key is a pair ``(k0, k1)`` of int64 tensors of one shape (a batch of
keys) or of Python ints.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(key: Key, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pair (x0, x1)
    under ``key``; all operands broadcast."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return 0, seed


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in`` of int32 ``data`` (one key per element):
    the hash of the count pair (0, uint32(data))."""
    d = data.to(torch.int64) & M32
    return threefry2x32(key, torch.zeros_like(d), d)


def split2(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key, 2)`` (fold-like, partitionable): key i is
    the hash of the count pair (0, i)."""
    zero = torch.zeros_like(torch.as_tensor(key[0]), dtype=torch.int64)
    a = threefry2x32(key, zero, zero)
    b = threefry2x32(key, zero, zero + 1)
    return a, b


def randint(key: Key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval, dtype=int32)`` for
    each key of a batch: (*key shape, n) int64 values in [minval, maxval).
    Two 32-bit words per value, reduced modulo the span in uint32
    arithmetic as JAX reduces them."""
    span = maxval - minval
    if not 0 < span < 2 ** 31 or not -2 ** 31 <= minval < 2 ** 31:
        raise ValueError(f"randint range [{minval}, {maxval})")
    ka, kb = split2(key)
    # both keys' bits in one hash: the keys stacked on a leading axis
    k0 = torch.stack([ka[0], kb[0]])[..., None]
    k1 = torch.stack([ka[1], kb[1]])[..., None]
    counts = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32((k0, k1), torch.zeros_like(counts), counts)
    bits = b0 ^ b1  # 32 random bits per value and key
    higher, lower = bits[0], bits[1]
    # 2**32 % span, computed as JAX does: the uint32 square may wrap
    multiplier = ((2 ** 16 % span) ** 2 & M32) % span
    offset = ((higher % span) * multiplier + lower % span) & M32
    return minval + offset % span
