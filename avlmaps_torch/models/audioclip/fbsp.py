"""Frequency-B-spline (FBSP) complex filterbank and signal framing.

Counterpart of ``avlmaps_tpu/models/audioclip/fbsp.py`` (reference
avlmaps/audioclip/model/esresnet/fbsp.py:19-160, LinearFBSP and the
frame-based spectrogram, and avlmaps/audioclip/utils/transforms.py
frame_signal).  Complex values are carried as a trailing dim of size 2
(re, im), the checkpoint's layout; the filterbank is two real matmuls,
summed in f64 (see :func:`fbsp_apply`).

The kernels are ``cos(fc * t)`` with ``fc`` up to n_fft / 2 and ``t`` on
[-pi, pi], so the phase reaches ~3.2e3 rad and one ulp of ``t`` moves a
kernel entry by ~4e-4 before the 1/sqrt(n_fft) normalisation:
:func:`fbsp_grid` builds ``t`` with the JAX package's arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def blackmanharris_window(n: int) -> np.ndarray:
    """Periodic (fftbins=True) 4-term Blackman-Harris window, as
    scipy.signal.get_window('blackmanharris', n) returns it."""
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    k = np.arange(n) * (2 * np.pi / n)
    return (a[0] - a[1] * np.cos(k) + a[2] * np.cos(2 * k)
            - a[3] * np.cos(3 * k)).astype(np.float64)


def frame_signal(signal: torch.Tensor, frame_length: int, hop_length: int,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split (B, T) signals into overlapping windowed frames (B,
    num_frames, frame_length), centring the zero padding the last frame
    needs (reference transforms.frame_signal)."""
    t = signal.shape[-1]
    if t <= frame_length:
        num_frames = 1
    else:
        num_frames = 1 + int(math.ceil((t - frame_length) / hop_length))
    pad_len = (num_frames - 1) * hop_length + frame_length
    if pad_len > t:
        extra = pad_len - t
        signal = F.pad(signal, (extra // 2, extra - extra // 2))
    frames = signal.unfold(-1, frame_length, hop_length)
    if window is not None:
        frames = frames * window
    return frames


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the f64 product of two f32 values
    is exact, so only the sum and the cast round."""
    return (a.double() * b.double() + c.double()).float()


def fbsp_grid(in_features: int, eps: float = 1e-8,
              device=None) -> torch.Tensor:
    """(1, in_features) ``pi * linspace(-1, 1, in_features) + eps`` in f32,
    as the JAX package's ``fbsp_weights`` computes it op by op on the CPU.

    ``jnp.linspace`` is ``-1 * (1 - s) + 1 * s`` with ``s = iota *
    f32(1 / (n - 1))``, the end point appended; XLA's CPU backend
    contracts both sums into fused multiply-adds, giving
    ``fma(iota, c, -fma(-iota, c, 1))``, which is what this returns: the
    same bits at n = 2048, the full-width n_fft.  Where XLA fuses more
    (other sizes, or the grid inside one jitted tower) it contracts in
    other places and ``t`` moves by a few ulps, which moves kernel entries
    by up to ~2e-5 (of ~3e-2) at n_fft = 2048."""
    div = in_features - 1
    if div <= 0:
        lin = torch.full((max(in_features, 0),), -1.0, device=device)
    else:
        it = torch.arange(div, dtype=torch.float32, device=device)
        c = torch.full_like(it, float(np.float32(1.0) / np.float32(div)))
        one = torch.ones_like(it)
        lin = torch.cat([_fma(it, c, -_fma(-it, c, one)),
                         torch.ones(1, device=device)])
    return (lin * math.pi + eps).reshape(1, -1)


def fbsp_weights(m: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                 in_features: int, normalized: bool = True,
                 eps: float = 1e-8) -> torch.Tensor:
    """The (out, in, 2) complex FBSP kernels from the learned order (m),
    bandwidth (fb) and centre frequency (fc) (reference
    LinearFBSP._materialize_weights, fbsp.py:67-97), in f32."""
    t = fbsp_grid(in_features, eps, m.device)
    m_ = m.float().reshape(-1, 1)
    fb_ = fb.float().reshape(-1, 1)
    fc_ = fc.float().reshape(-1, 1)

    kernel_re = torch.cos(fc_ * t)
    kernel_im = -torch.sin(fc_ * t)
    scale = torch.sqrt(fb_)
    x = fb_ * t / (m_ + eps)
    win = torch.where(x == 0, torch.ones_like(x), torch.sin(x) / x)

    # complex power win**m for real win and real m, in the JAX package's
    # form: |win|^m * (cos(m * phase), sin(m * phase)), phase = atan2(0, win)
    mag = torch.abs(win)
    phase = torch.atan2(torch.zeros_like(win), win)
    mag_out = (mag ** 2) ** (0.5 * m_)
    win_re = mag_out * torch.cos(m_ * phase)
    win_im = mag_out * torch.sin(m_ * phase)

    w_re = scale * (win_re * kernel_re - win_im * kernel_im)
    w_im = scale * (win_re * kernel_im + win_im * kernel_re)
    if normalized:
        inv = 1.0 / np.sqrt(in_features)
        w_re = w_re * inv
        w_im = w_im * inv
    return torch.stack([w_re, w_im], dim=-1)


def fbsp_apply(frames: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Apply the complex filterbank to real frames: (..., in) x (out, in,
    2) -> (..., out, 2) f32 (reference LinearFBSP.forward, real branch,
    fbsp.py:99-115), with f64 products and sums.

    The zero padding of an event's 5 s context becomes a constant frame
    after :func:`scale_signal` (0 maps to ~1.5e-5), and the filterbank
    nearly cancels it: the true sums are ~1e-12 while an f32 sum of 2048
    terms carries ~1e-12 of rounding, so two f32 implementations (CPU
    and card, or two summation orders) put those bins up to ~1 dB apart
    and the embedding's cosine drops to ~0.999.  Summed in f64 the bins
    are the same on every device to f32 rounding."""
    x = frames.double()
    re = torch.matmul(x, weights[..., 0].double().T)
    im = torch.matmul(x, weights[..., 1].double().T)
    return torch.stack([re, im], dim=-1).float()


def scale_signal(x: torch.Tensor, old_min=-32768.0, old_max=32767.0,
                 new_min=-1.0, new_max=1.0) -> torch.Tensor:
    """Linear range remap (reference transforms.scale through
    base._forward_pre_processing: int16 range -> [-1, 1])."""
    return (x - old_min) / (old_max - old_min) * (new_max - new_min) + new_min
