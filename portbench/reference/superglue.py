"""SuperPoint and SuperGlue (github.com/magicleap/SuperGluePretrainedNetwork,
``models/superpoint.py`` and ``models/superglue.py``) as plain functions
of a state dict, for the image query's check.

The state dict has the benchmark's key layout: SuperPoint's is
``superpoint_v1.pth``'s (``conv1a.weight`` ...); SuperGlue's has the
BatchNorms folded into the layers before them (``kenc.enc<i>``,
``gnn.<i>.{q,k,v,merge,mlp0,mlp1}``, ``final_proj``, ``bin_score``), each
a dense layer applied as the release's 1x1 ``Conv1d`` on (B, D, N).

SuperPoint: the VGG encoder (ReLU, 2x2 max-pools after convs 1b, 2b,
3b), the detector's softmax over 65 channels without the dustbin, put
back to pixels cell by cell, and the descriptor head normalised.  Its
keypoints are selected as the port states them (``avlmaps_torch/models/
superpoint/model.py``): a pixel is kept where it equals the max of its
(2r + 1)^2 window, the kept scores are sorted descending, equal scores
lowest flat index first, the first ``max_keypoints`` taken, those above
``score_threshold`` valid.  (The release's ``simple_nms`` suppresses in
two further passes and drops a 4-pixel border; this check holds the port
to its own selection.)  Descriptors are read with the release's
``grid_sample`` mapping and normalised.

SuperGlue: keypoints normalised by 0.7 x the image's longer side about
its centre; the keypoint MLP on (x, y, score) added to the descriptors;
``gnn_layers`` pairs of self then cross propagation, heads strided (the
release views (B, D, N) as (B, D / H, H, N)), both cross deltas read the
descriptors before the pair's cross update; the final projection; scores
over sqrt(D); the log-domain Sinkhorn with the dustbin, u then v each
iteration.  It runs on the valid keypoints alone: no padding, no mask.
The release's decision: mutual best pairs whose probability passes the
match threshold.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
           "conv4a", "conv4b")


def gray(rgb_u8: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> f32 gray in [0, 1]: OpenCV's ``COLOR_RGB2GRAY``
    in its 15-bit fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15,
    over 255."""
    c = rgb_u8.astype(np.int64)
    y = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + (1 << 14)) >> 15
    return y.astype(np.float32) / 255.0


def _conv(sd, name: str, x, p: Precision):
    w = sd[f"{name}.weight"]
    return F.conv2d(p.q(x), p.q(w), sd[f"{name}.bias"].float(),
                    padding=w.shape[-1] // 2)


def superpoint_maps(sd: Dict[str, torch.Tensor], images: torch.Tensor,
                    p: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) gray, H and W multiples of 8 -> (scores (B, H, W),
    descriptors (B, D, H / 8, W / 8) normalised)."""
    with p.products():
        x = images[:, None].float()
        for i, name in enumerate(ENCODER):
            x = F.relu(_conv(sd, name, x, p))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        prob = F.softmax(_conv(sd, "convPb", F.relu(_conv(sd, "convPa", x,
                                                          p)), p), 1)[:, :-1]
        b, _, hc, wc = prob.shape
        scores = prob.permute(0, 2, 3, 1).reshape(b, hc, wc, 8, 8)
        scores = scores.permute(0, 1, 3, 2, 4).reshape(b, hc * 8, wc * 8)
        desc = _conv(sd, "convDb", F.relu(_conv(sd, "convDa", x, p)), p)
        desc = F.normalize(desc, p=2, dim=1)
    return scores, desc


def select(scores: torch.Tensor, radius: int, max_kp: int,
           threshold: float) -> Dict[str, torch.Tensor]:
    """One (H, W) score map -> the valid keypoints: ``keypoints`` (N, 2)
    xy and ``scores`` (N,), in the order of the selection."""
    h, w = scores.shape
    k = 2 * radius + 1
    peak = F.max_pool2d(scores[None, None], k, stride=1,
                        padding=radius)[0, 0]
    kept = torch.where(scores == peak, scores, torch.zeros_like(scores))
    order = torch.sort(kept.reshape(-1), descending=True, stable=True)
    top, idx = order.values[:max_kp], order.indices[:max_kp]
    ok = top > threshold
    idx, top = idx[ok], top[ok]
    xy = torch.stack([idx % w, idx // w], -1).float()
    return {"keypoints": xy, "scores": top}


def sample_descriptors(desc: torch.Tensor, xy: torch.Tensor,
                       s: int = 8) -> torch.Tensor:
    """The release's ``sample_descriptors``: (D, Hc, Wc), (N, 2) pixels ->
    (N, D) normalised."""
    _, hc, wc = desc.shape
    g = xy - s / 2 + 0.5
    g = g / torch.tensor([wc * s - s / 2 - 0.5, hc * s - s / 2 - 0.5],
                         device=xy.device)
    g = (g * 2 - 1).view(1, 1, -1, 2)
    out = F.grid_sample(desc[None], g, mode="bilinear", align_corners=True)
    return F.normalize(out.reshape(desc.shape[0], -1), p=2, dim=0).T


def superpoint(sd: Dict[str, torch.Tensor], gray_image: torch.Tensor,
               cfg: Dict, p: Precision) -> Dict[str, torch.Tensor]:
    """One (H, W) gray image -> its valid ``keypoints``, ``scores`` and
    ``descriptors`` (N, D); the image is zero-padded to multiples of 8
    and the padding's scores zeroed."""
    h, w = gray_image.shape
    x = F.pad(gray_image, (0, -w % 8, 0, -h % 8))
    scores, desc = superpoint_maps(sd, x[None], p)
    scores = scores[0].clone()
    scores[h:] = 0.0
    scores[:, w:] = 0.0
    out = select(scores, cfg["nms_radius"], cfg["max_keypoints"],
                 cfg["score_threshold"])
    out["descriptors"] = sample_descriptors(desc[0], out["keypoints"])
    return out


# -- SuperGlue ----------------------------------------------------------------

def _dense(sd, name: str, x, p: Precision):
    """A 1x1 Conv1d on (B, C, N)."""
    return F.conv1d(p.q(x), p.q(sd[f"{name}.weight"][..., None]),
                    sd[f"{name}.bias"].float())


def _normalize_keypoints(kpts: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    size = torch.tensor([float(w), float(h)], device=kpts.device)
    return (kpts - size / 2) / (size.max() * 0.7)


def _keypoint_encoder(sd, kpts, scores, hw, p: Precision):
    x = torch.cat([_normalize_keypoints(kpts, hw).T, scores[None]], 0)[None]
    n = len({k.split(".")[1] for k in sd if k.startswith("kenc.")})
    for i in range(n):
        x = _dense(sd, f"kenc.enc{i}", x, p)
        if i < n - 1:
            x = F.relu(x)
    return x


def _propagate(sd, k: str, x, source, heads: int, p: Precision):
    b, d, _ = x.shape
    dim = d // heads
    q, kk, v = (_dense(sd, k + name, t, p).view(b, dim, heads, -1)
                for name, t in (("q", x), ("k", source), ("v", source)))
    logits = torch.einsum("bdhn,bdhm->bhnm", p.q(q), p.q(kk)) / dim ** 0.5
    msg = torch.einsum("bhnm,bdhm->bdhn", p.q(F.softmax(logits, dim=-1)),
                       p.q(v))
    msg = _dense(sd, k + "merge", msg.contiguous().view(b, d, -1), p)
    y = F.relu(_dense(sd, k + "mlp0", torch.cat([x, msg], 1), p))
    return _dense(sd, k + "mlp1", y, p)


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """The release's ``log_optimal_transport`` on (B, M, N) scores."""
    b, m, n = scores.shape
    ms, ns = scores.new_tensor(m), scores.new_tensor(n)
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    alpha = alpha.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1),
                           torch.cat([bins1, alpha], -1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    log_mu, log_nu = log_mu[None].expand(b, -1), log_nu[None].expand(b, -1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def superglue(sd: Dict[str, torch.Tensor], f0: Dict, f1: Dict, hw0, hw1,
              cfg: Dict, p: Precision) -> torch.Tensor:
    """The log assignment (N0 + 1, N1 + 1) of two sets of valid keypoints:
    ``f*`` hold ``keypoints`` (N, 2), ``scores`` (N,), ``descriptors``
    (N, D)."""
    heads = cfg["heads"]
    with p.products():
        d0 = f0["descriptors"].float().T[None] + _keypoint_encoder(
            sd, f0["keypoints"].float(), f0["scores"].float(), hw0, p)
        d1 = f1["descriptors"].float().T[None] + _keypoint_encoder(
            sd, f1["keypoints"].float(), f1["scores"].float(), hw1, p)
        for i in range(2 * cfg["gnn_layers"]):
            k = f"gnn.{i}."
            src0, src1 = (d1, d0) if i % 2 else (d0, d1)
            delta0 = _propagate(sd, k, d0, src0, heads, p)
            delta1 = _propagate(sd, k, d1, src1, heads, p)
            d0, d1 = d0 + delta0, d1 + delta1
        m0 = _dense(sd, "final_proj", d0, p)
        m1 = _dense(sd, "final_proj", d1, p)
        scores = torch.einsum("bdn,bdm->bnm", p.q(m0), p.q(m1)) \
            / cfg["desc_dim"] ** 0.5
    z = log_optimal_transport(scores.float(), sd["bin_score"].float(),
                              cfg["sinkhorn_iters"])
    return z[0]


def matches(z: torch.Tensor, threshold: float) -> torch.Tensor:
    """The release's decision on a log assignment (N0 + 1, N1 + 1): row
    i's match is its best column j where j's best row is i and exp(Z_ij)
    passes ``threshold``, else -1; (N0,) int64."""
    inner = z[:-1, :-1]
    none = torch.full((inner.shape[0],), -1, dtype=torch.int64,
                      device=z.device)
    if inner.numel() == 0:
        return none
    best0, idx0 = inner.max(dim=1)
    idx1 = inner.max(dim=0).indices
    mutual = idx1[idx0] == torch.arange(len(idx0), device=z.device)
    return torch.where(mutual & (best0.exp() > threshold), idx0, none)
