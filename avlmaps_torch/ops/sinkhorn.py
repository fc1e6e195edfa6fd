"""SuperGlue's masked log-domain Sinkhorn with a dustbin row and column.

``sinkhorn`` is SuperGlue's ``log_optimal_transport`` on the valid
submatrix, in f32: the marginals use the VALID counts, padded rows and
columns get ``NEG`` log-mass, and ``v`` starts at ``NEG`` on padded
columns, so the first ``u`` update sums the valid set alone, as the
unpadded release does.  Each iteration updates ``u`` first, then ``v``, as
the JAX package does.

A tensor on the CPU takes the plain version, :func:`sinkhorn_ref` (the
loop of torch ops); a CUDA tensor launches the kernels of
``csrc/sinkhorn.cu`` from one host call or raises.  ``sinkhorn.launches``
counts the kernel path's calls (one a Sinkhorn, however many iterations).
"""

from __future__ import annotations

import torch

from avlmaps_torch.kernels import build
from avlmaps_torch.kernels.build import require

NEG = -1e9  # masked log-mass / attention logit: exp(NEG) == 0.0 in f32


def _marginals(valid0: torch.Tensor, valid1: torch.Tensor,
               dev: torch.device):
    """(norm (B, 1), log_mu (B, M+1), log_nu (B, N+1), v's start (B, N+1))."""
    nv0 = valid0.sum(dim=1).float()
    nv1 = valid1.sum(dim=1).float()
    norm = -torch.log(torch.clamp(nv0 + nv1, min=1.0))[:, None]  # (B, 1)

    def safe_log(x):
        return torch.log(torch.clamp(x, min=1e-30))

    # made on the device: a host scalar's copy would wait for the card
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    log_mu = torch.cat([torch.where(valid0, norm, neg),
                        safe_log(nv1)[:, None] + norm], dim=1)
    log_nu = torch.cat([torch.where(valid1, norm, neg),
                        safe_log(nv0)[:, None] + norm], dim=1)
    # padded columns start masked, so the first u update sums the valid
    # set alone, as the unpadded release does
    v = torch.where(log_nu > neg, 0.0, neg)
    return norm, log_mu, log_nu, v


def sinkhorn_ref(scores: torch.Tensor, alpha, valid0: torch.Tensor,
                 valid1: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: the (B, M+1, N+1) log assignment by a loop of torch
    ops, each half-update a broadcast sum and ``torch.logsumexp``."""
    b, m, n = scores.shape
    dev = scores.device
    scores = scores.float()
    norm, log_mu, log_nu, v = _marginals(valid0, valid1, dev)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(
        1, 1, 1).expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, a.expand(b, m, 1)], dim=2),
                           torch.cat([a.expand(b, 1, n), a], dim=2)], dim=1)
    u = torch.zeros_like(log_mu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[..., None]


def _pitch(k: int) -> int:
    """Floats a row of ``k`` takes in the kernels' buffers: a multiple of
    4, so rows start on 16 bytes."""
    return (k + 3) // 4 * 4


def sinkhorn(scores: torch.Tensor, alpha, valid0: torch.Tensor,
             valid1: torch.Tensor, iters: int) -> torch.Tensor:
    """(B, M, N) scores, the dustbin score ``alpha`` (a number or a
    one-element tensor), (B, M) and (B, N) bool validity masks ->
    (B, M+1, N+1) f32 log assignment after ``iters`` iterations."""
    require(scores.dim() == 3, "sinkhorn: need (B, M, N) scores, got {}",
            tuple(scores.shape))
    b, m, n = scores.shape
    require(tuple(valid0.shape) == (b, m) and tuple(valid1.shape) == (b, n),
            "sinkhorn: masks {}, {} do not fit scores {}",
            tuple(valid0.shape), tuple(valid1.shape), tuple(scores.shape))
    require(iters >= 0, "sinkhorn: iters must be >= 0, got {}", iters)
    if scores.device.type == "cpu":
        return sinkhorn_ref(scores, alpha, valid0, valid1, iters)
    require(scores.is_cuda, "sinkhorn: unsupported device {}", scores.device)
    require(b < 65536, "sinkhorn: at most 65535 pairs a call, got {}", b)
    require(max(m, n) < 1 << 20, "sinkhorn: at most 2^20 - 1 keypoints a "
            "side, got {} x {}", m, n)
    dev = scores.device
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty((b, m + 1, n + 1), **f32)
    if b == 0:
        return z
    scores = scores.float().contiguous()
    norm, log_mu, log_nu, v0 = _marginals(valid0, valid1, dev)
    a = torch.as_tensor(alpha, **f32).reshape(1).contiguous()
    p0, p1 = _pitch(m + 1), _pitch(n + 1)
    c = torch.empty((b, m + 1, p1), **f32)
    ct = torch.empty((b, n + 1, p0), **f32)
    u = torch.zeros((b, p0), **f32)
    v = torch.zeros((b, p1), **f32)
    v[:, :n + 1] = v0
    build.check(build.load("sinkhorn").avl_sinkhorn(
        scores.data_ptr(), a.data_ptr(), log_mu.data_ptr(),
        log_nu.data_ptr(), norm.data_ptr(), u.data_ptr(), v.data_ptr(),
        c.data_ptr(), ct.data_ptr(), z.data_ptr(), b, m, n, p0, p1, iters,
        torch.cuda.current_stream(dev).cuda_stream), "sinkhorn")
    sinkhorn.launches += 1
    return z


sinkhorn.launches = 0
