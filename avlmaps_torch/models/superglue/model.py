"""SuperGlue attentional graph matcher in PyTorch.

Counterpart of ``avlmaps_tpu/models/superglue/model.py``: the reference
matches SuperPoint keypoints with HLoc's SuperGlue (avlmaps/utils/
localization_utils.py:140-145, 221-273): a keypoint-position MLP encoder,
alternating self/cross attention layers, a final projection and a
log-domain Sinkhorn with a learned dustbin.  As in the JAX package:

* both keypoint sets are FIXED-size with validity masks (the SuperPoint
  extractor pads to ``max_keypoints``); padding gets ``NEG = -1e9``
  log-mass and attention logits, never ``-inf`` (a ``logsumexp`` over an
  all-padded row of ``-inf`` is NaN), so the valid block equals the
  unpadded computation to float rounding;
* heads are STRIDED, not blocked: head h owns channels ``c % heads ==
  h`` (the torch original views (b, d, n) as (b, head_dim, heads, n));
* inference only: the checkpoints' BatchNorm1d layers are folded into
  the preceding dense layers when the weights are ported (``port.py``).

Everything runs in f32 under ``full_f32``: the match decision is an
argmax, and TF32 would flip it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.utils.device import full_f32, resolve_device, to_device

NEG = -1e9  # masked log-mass / attention logit: exp(NEG) == 0.0 in f32


@dataclasses.dataclass(frozen=True)
class SuperGlueConfig:
    desc_dim: int = 256
    kenc_layers: Tuple[int, ...] = (32, 64, 128, 256)
    gnn_layers: int = 9          # self+cross pairs (public checkpoints: 9)
    heads: int = 4
    sinkhorn_iters: int = 20     # the ported config takes MagicLeap's 100
    match_threshold: float = 0.2

    @staticmethod
    def tiny() -> "SuperGlueConfig":
        return SuperGlueConfig(desc_dim=32, kenc_layers=(8, 16),
                               gnn_layers=2, heads=4, sinkhorn_iters=10)


def normalize_keypoints(kpts: torch.Tensor, hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """(B, K, 2) xy pixels -> centred coords scaled by 0.7 * max(h, w)."""
    h, w = hw
    center = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32,
                          device=kpts.device)
    return (kpts - center) / (0.7 * max(h, w))


class KeypointEncoder(nn.Module):
    """MLP over (x, y, score), layers ``enc0`` .. ``enc<n>`` (BN folded)."""

    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        widths = (3,) + tuple(cfg.kenc_layers) + (cfg.desc_dim,)
        for i in range(len(widths) - 1):
            setattr(self, f"enc{i}", nn.Linear(widths[i], widths[i + 1]))
        self.n = len(widths) - 1

    def forward(self, kpts, scores, hw: Tuple[int, int]):
        x = torch.cat([normalize_keypoints(kpts, hw), scores[..., None]],
                      dim=-1)
        for i in range(self.n):
            x = getattr(self, f"enc{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class Propagation(nn.Module):
    """One attentional propagation delta: MLP([x, attn(x, src, src)]).
    One instance serves both images of a layer (shared weights)."""

    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        d = cfg.desc_dim
        self.heads = cfg.heads
        self.q, self.k, self.v, self.merge = (nn.Linear(d, d)
                                              for _ in range(4))
        self.mlp0 = nn.Linear(2 * d, 2 * d)
        self.mlp1 = nn.Linear(2 * d, d)

    def forward(self, x, src, src_valid):
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        # strided heads: (b, n, d) -> (b, n, hd, h), channel c -> head c % h
        q = self.q(x).reshape(b, n, hd, h)
        k = self.k(src).reshape(b, src.shape[1], hd, h)
        v = self.v(src).reshape(b, src.shape[1], hd, h)
        logits = torch.einsum("bqdh,bkdh->bhqk", q, k) / (hd ** 0.5)
        logits = torch.where(src_valid[:, None, None, :], logits,
                             torch.full_like(logits, NEG))
        prob = torch.softmax(logits, dim=-1)
        msg = torch.einsum("bhqk,bkdh->bqdh", prob, v).reshape(b, n, d)
        y = torch.cat([x, self.merge(msg)], dim=-1)
        return self.mlp1(F.relu(self.mlp0(y)))


class SuperGlueNet(nn.Module):
    """Full matcher, parameters on ``device`` (``"meta"`` for shapes):
    returns the (B, K0+1, K1+1) log assignment matrix."""

    def __init__(self, cfg: SuperGlueConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.kenc = KeypointEncoder(cfg)
            self.gnn = nn.ModuleList(Propagation(cfg)
                                     for _ in range(2 * cfg.gnn_layers))
            self.final_proj = nn.Linear(cfg.desc_dim, cfg.desc_dim)
            self.bin_score = nn.Parameter(torch.tensor(1.0))

    def forward(self, kpts0, scores0, desc0, valid0,
                kpts1, scores1, desc1, valid1,
                hw0: Tuple[int, int],
                hw1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``desc*``: L2-normalised SuperPoint descriptors (B, K, D);
        padded entries must be finite (zeros are fine).  Each set is
        normalised by ITS OWN image shape (``hw1`` defaults to ``hw0``)."""
        with full_f32():
            d0 = desc0.float() + self.kenc(kpts0, scores0, hw0)
            d1 = desc1.float() + self.kenc(kpts1, scores1,
                                           hw1 if hw1 is not None else hw0)
            for pair in range(self.cfg.gnn_layers):
                self_prop = self.gnn[2 * pair]
                cross_prop = self.gnn[2 * pair + 1]
                d0 = d0 + self_prop(d0, d0, valid0)
                d1 = d1 + self_prop(d1, d1, valid1)
                # both cross deltas read the PRE-update descriptors
                d0n = d0 + cross_prop(d0, d1, valid1)
                d1 = d1 + cross_prop(d1, d0, valid0)
                d0 = d0n
            m0, m1 = self.final_proj(d0), self.final_proj(d1)
            scores = torch.einsum("bnd,bmd->bnm", m0, m1) \
                / self.cfg.desc_dim ** 0.5
        return log_optimal_transport(scores, self.bin_score, valid0, valid1,
                                     self.cfg.sinkhorn_iters)


def log_optimal_transport(scores: torch.Tensor, alpha, valid0: torch.Tensor,
                          valid1: torch.Tensor, iters: int) -> torch.Tensor:
    """Masked log-domain Sinkhorn with a dustbin row and column, in f32.

    SuperGlue's ``log_optimal_transport`` on the valid submatrix: the
    marginals use the VALID counts and padded rows/columns get ``NEG``
    log-mass.  Each iteration updates ``u`` first, then ``v``, as the
    JAX package does."""
    b, m, n = scores.shape
    dev = scores.device
    scores = scores.float()
    nv0 = valid0.sum(dim=1).float()
    nv1 = valid1.sum(dim=1).float()
    norm = -torch.log(torch.clamp(nv0 + nv1, min=1.0))[:, None]  # (B, 1)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(
        1, 1, 1).expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, a.expand(b, m, 1)], dim=2),
                           torch.cat([a.expand(b, 1, n), a], dim=2)], dim=1)

    def safe_log(x):
        return torch.log(torch.clamp(x, min=1e-30))

    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    log_mu = torch.cat([torch.where(valid0, norm, neg),
                        safe_log(nv1)[:, None] + norm], dim=1)
    log_nu = torch.cat([torch.where(valid1, norm, neg),
                        safe_log(nv0)[:, None] + norm], dim=1)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[..., None]


def match_from_assignment(Z: torch.Tensor, valid0: torch.Tensor,
                          valid1: torch.Tensor, threshold: float = 0.2):
    """Mutual-max matches from the log assignment (SuperGlue's decision
    rule): (matches0 (B, K0) int32 index into set 1 or -1, mscores0
    (B, K0) exp log-prob).  Argmax ties go to the first index."""
    inner = Z[:, :-1, :-1]
    inner = torch.where(valid0[:, :, None] & valid1[:, None, :], inner,
                        torch.full_like(inner, NEG))
    max0 = inner.amax(dim=2)
    idx0 = torch.argmax(inner, dim=2)
    idx1 = torch.argmax(inner, dim=1)
    mutual0 = torch.gather(idx1, 1, idx0) == torch.arange(
        inner.shape[1], device=Z.device)[None]
    mscores0 = torch.where(mutual0, torch.exp(max0),
                           torch.zeros_like(max0))
    ok = mutual0 & (mscores0 > threshold) & valid0
    return torch.where(ok, idx0, -1).to(torch.int32), mscores0


class SuperGlueMatcher:
    """SuperGlue on ``device`` (default ``"cuda"``; raises without a card)
    with the JAX package's ``match`` interface.

    ``params`` is a state_dict of :class:`SuperGlueNet` (``port.
    params_from_flax`` or ``port.load_superglue_checkpoint``);
    ``params=None`` draws seeded random weights at ``cfg``'s width."""

    def __init__(self, cfg: SuperGlueConfig = SuperGlueConfig(),
                 params=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from avlmaps_torch.models.superglue.port import init_params

        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen)
        self.model = SuperGlueNet(cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    def _inputs(self, feats):
        dev = self.device
        return (to_device(feats["keypoints"], dev, torch.float32),
                to_device(feats["scores"], dev, torch.float32),
                to_device(feats["descriptors"], dev, torch.float32),
                to_device(feats["valid"], dev, torch.bool))

    @torch.no_grad()
    def assignment(self, feats0, feats1, hw: Tuple[int, int],
                   hw1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The (B, K0+1, K1+1) log assignment Z on the device."""
        return self.model(*self._inputs(feats0), *self._inputs(feats1),
                          tuple(hw), tuple(hw1) if hw1 is not None else None)

    @torch.no_grad()
    def match(self, feats0, feats1, hw: Tuple[int, int],
              hw1: Optional[Tuple[int, int]] = None):
        """feats: dicts with keypoints (B, K, 2), scores (B, K),
        descriptors (B, K, D), valid (B, K) (the SuperPoint extractor's
        output); ``hw``: image shape of set 0, ``hw1`` of set 1 (defaults
        to ``hw``).  Returns (matches0 (B, K0) int32, mscores0 (B, K0)) as
        tensors on the device."""
        Z = self.assignment(feats0, feats1, hw, hw1)
        return match_from_assignment(
            Z, to_device(feats0["valid"], self.device, torch.bool),
            to_device(feats1["valid"], self.device, torch.bool),
            threshold=self.cfg.match_threshold)
