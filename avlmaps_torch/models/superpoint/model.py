"""SuperPoint keypoint detector and descriptor in PyTorch.

Counterpart of ``avlmaps_tpu/models/superpoint/model.py``: the MagicLeap
SuperPointNet (a VGG encoder, a detector head of 8x8 cells + dustbin and
a descriptor head), as the reference runs it through HLoc's
'superpoint_aachen' extractor (avlmaps/utils/localization_utils.py:
127-145).  As in the JAX package, detection returns a FIXED number of
keypoints (top-K after max-pool NMS) with a validity mask, and
descriptors are sampled bilinearly at the keypoints with MagicLeap's
``grid_sample`` mapping.

The convolutions run NCHW in f32 under ``full_f32`` (cuDNN's TF32 would
move scores across the top-K cut and flip the matcher's argmaxes).  The
module's parameter names are ``superpoint_v1.pth``'s keys, so the public
checkpoint loads straight into it (``port.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.utils.device import full_f32, resolve_device, to_device

LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    channels: Tuple[int, ...] = (64, 64, 128, 128)  # c1..c4, two convs each
    det_ch: int = 256
    desc_ch: int = 256
    desc_dim: int = 256
    nms_radius: int = 4
    max_keypoints: int = 1024
    score_threshold: float = 0.005

    @staticmethod
    def tiny() -> "SuperPointConfig":
        return SuperPointConfig(channels=(8, 8, 16, 16), det_ch=32,
                                desc_ch=32, desc_dim=32, max_keypoints=64,
                                score_threshold=0.0)


class SuperPointNet(nn.Module):
    """VGG encoder + detector/descriptor heads, parameters on ``device``
    (``"meta"`` for shapes only)."""

    def __init__(self, cfg: SuperPointConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3, c4 = cfg.channels
        plan = ((1, c1), (c1, c1), (c1, c2), (c2, c2), (c2, c3), (c3, c3),
                (c3, c4), (c4, c4), (c4, cfg.det_ch), (cfg.det_ch, 65),
                (c4, cfg.desc_ch), (cfg.desc_ch, cfg.desc_dim))
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            for name, (cin, cout) in zip(LAYERS, plan):
                k = 1 if name in ("convPb", "convDb") else 3
                setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, gray: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """gray: (B, H, W) f32 in [0, 1], H and W multiples of 8.

        Returns (scores (B, H, W), descriptors (B, H/8, W/8, D)
        L2-normalised)."""
        with full_f32():
            x = gray[:, None].float()
            for i, name in enumerate(LAYERS[:8]):
                x = F.relu(getattr(self, name)(x))
                if i in (1, 3, 5):
                    x = F.max_pool2d(x, 2)
            logits = self.convPb(F.relu(self.convPa(x)))
            probs = torch.softmax(logits, dim=1)[:, :64]
            b, _, hc, wc = probs.shape
            # depth-to-space: channel i*8 + j -> pixel (hc*8 + i, wc*8 + j)
            scores = probs.reshape(b, 8, 8, hc, wc).permute(0, 3, 1, 4, 2)
            scores = scores.reshape(b, hc * 8, wc * 8)
            desc = self.convDb(F.relu(self.convDa(x)))
            desc = desc / torch.clamp(torch.linalg.vector_norm(
                desc, dim=1, keepdim=True), min=1e-8)
        return scores, desc.permute(0, 2, 3, 1)


def nms_scores(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only local maxima within ``radius`` (max-pool NMS; every pixel
    of a plateau equal to its neighbourhood's max is kept)."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(scores[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def select_keypoints(scores: torch.Tensor, max_kp: int, radius: int,
                     threshold: float):
    """(B, H, W) scores -> fixed-size keypoints: (xy (B, K, 2) f32 pixel
    coords, score (B, K), valid (B, K)).

    The top-K is a stable descending sort, so equal scores come lowest
    flat index first, as ``jax.lax.top_k`` orders them (``torch.topk`` on
    CUDA promises no order for ties); invalid rows then carry the JAX
    package's coordinates too."""
    b, h, w = scores.shape
    flat = nms_scores(scores, radius).reshape(b, -1)
    top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_kp], idx[:, :max_kp]
    xy = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return xy, top, top > threshold


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor
                       ) -> torch.Tensor:
    """Bilinear-sample the 1/8-res descriptor map (B, Hc, Wc, D) at
    full-res pixel coords xy (B, K, 2) and re-normalise.

    MagicLeap's mapping: ``grid_sample`` with ``align_corners=True`` at
    ``2*(x - 3.5)/(8*wc - 4.5) - 1`` is cell coord ``(x - 3.5)*(wc - 1)/
    (8*wc - 4.5)``, not ``(x - 3.5)/8``.  Corners are clamped to the map
    (an out-of-range neighbour only rescales what the L2 norm removes)."""
    bsz, hc, wc, d = desc_map.shape
    sx = (xy[..., 0] - 3.5) * ((wc - 1) / (8.0 * wc - 4.5))
    sy = (xy[..., 1] - 3.5) * ((hc - 1) / (8.0 * hc - 4.5))
    x0 = torch.clamp(torch.floor(sx), 0, wc - 1).long()
    y0 = torch.clamp(torch.floor(sy), 0, hc - 1).long()
    x1 = torch.clamp(x0 + 1, max=wc - 1)
    y1 = torch.clamp(y0 + 1, max=hc - 1)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    bi = torch.arange(bsz, device=desc_map.device)[:, None]

    def g(yy, xx):
        return desc_map[bi, yy, xx]

    out = ((1 - fy) * (1 - fx) * g(y0, x0) + (1 - fy) * fx * g(y0, x1)
           + fy * (1 - fx) * g(y1, x0) + fy * fx * g(y1, x1))
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1,
                                                      keepdim=True), min=1e-8)


def mutual_nearest_matches(desc_a: torch.Tensor, desc_b: torch.Tensor,
                           valid_a: torch.Tensor, valid_b: torch.Tensor,
                           min_score: float = 0.0, ratio: bool = False):
    """Mutual-nearest-neighbour matching with one (Ka, Kb) f32 product.

    Returns (match_idx (Ka,) int32 index into b or -1, score (Ka,)):
    cross-checked, above ``min_score``, optionally Lowe's ratio 0.95.
    Argmax ties go to the first index, as in JAX."""
    with full_f32():
        sim = desc_a.float() @ desc_b.float().T  # cosines: unit descriptors
    sim = torch.where(valid_a[:, None] & valid_b[None, :], sim,
                      torch.full_like(sim, float("-inf")))
    best_ab = torch.argmax(sim, dim=1)
    best_ba = torch.argmax(sim, dim=0)
    score = sim.max(dim=1).values
    mutual = best_ba[best_ab] == torch.arange(sim.shape[0],
                                              device=sim.device)
    ok = mutual & (score > min_score) & valid_a
    if ratio:
        top2 = torch.topk(sim, 2, dim=1).values
        ok = ok & (top2[:, 1] < 0.95 * top2[:, 0])
    return torch.where(ok, best_ab, -1).to(torch.int32), score


class SuperPointExtractor:
    """SuperPoint on ``device`` (default ``"cuda"``; raises without a
    card) with the JAX package's ``extract`` interface.

    ``params`` is a state_dict of :class:`SuperPointNet` (``port.
    params_from_flax`` or ``port.load_superpoint_checkpoint``);
    ``params=None`` draws seeded random weights at ``cfg``'s width."""

    def __init__(self, cfg: SuperPointConfig = SuperPointConfig(),
                 params=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from avlmaps_torch.models.superpoint.port import init_params

        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen)
        self.model = SuperPointNet(cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def extract_device(self, images_gray) -> dict:
        """(B, H, W) f32 in [0, 1] -> dict of fixed-size keypoint batches
        as tensors on the device.  Inputs are zero-padded to multiples of
        8 and the padded pixels' scores zeroed before the top-K."""
        g = to_device(images_gray, self.device, torch.float32)
        h, w = g.shape[1:3]
        ph, pw = (8 - h % 8) % 8, (8 - w % 8) % 8
        if ph or pw:
            g = F.pad(g, (0, pw, 0, ph))
        scores, desc_map = self.model(g)
        scores = scores.clone()
        scores[:, h:, :] = 0.0
        scores[:, :, w:] = 0.0
        cfg = self.cfg
        xy, sc, valid = select_keypoints(scores, cfg.max_keypoints,
                                         cfg.nms_radius, cfg.score_threshold)
        return {"keypoints": xy, "scores": sc, "valid": valid,
                "descriptors": sample_descriptors(desc_map, xy)}

    def extract(self, images_gray) -> dict:
        """:meth:`extract_device` with every array on the host (numpy)."""
        return {k: v.cpu().numpy()
                for k, v in self.extract_device(images_gray).items()}


__all__ = ["LAYERS", "SuperPointConfig", "SuperPointExtractor",
           "SuperPointNet", "mutual_nearest_matches", "nms_scores",
           "sample_descriptors", "select_keypoints"]
