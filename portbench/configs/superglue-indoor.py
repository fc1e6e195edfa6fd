"""superglue-indoor: the image query's SuperPoint and SuperGlue (f32) and
its retrieval tower, CLIP ViT-L/14's image tower as ``clip-vitl14``
states it: seeded weights, the port's networks built from them, and the
operation and byte counts of SuperGlue's two stages from (K0, K1)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.bench import clip, registry, roofline, weights


def _sp_rule(name: str, shape):
    if name.endswith(".bias"):
        return 0.0, 0.02
    return 0.0, (2.0 / weights.fan_in(shape)) ** 0.5  # He: ReLU convs


def _sg_rule(name: str, shape):
    if name == "bin_score":
        return 1.0, 0.0
    if name.endswith(".bias"):
        return 0.0, 0.02
    return 0.0, weights.fan_in(shape) ** -0.5


def superpoint_config(cfg: Dict):
    from avlmaps_torch.models.superpoint import SuperPointConfig

    s = cfg["superpoint"]
    return SuperPointConfig(channels=tuple(s["channels"]), det_ch=s["det_ch"],
                            desc_ch=s["desc_ch"], desc_dim=s["desc_dim"],
                            nms_radius=s["nms_radius"],
                            max_keypoints=s["max_keypoints"],
                            score_threshold=s["score_threshold"])


def superglue_config(cfg: Dict):
    from avlmaps_torch.models.superglue import SuperGlueConfig

    s = cfg["superglue"]
    return SuperGlueConfig(desc_dim=s["desc_dim"],
                           kenc_layers=tuple(s["kenc_layers"]),
                           gnn_layers=s["gnn_layers"], heads=s["heads"],
                           sinkhorn_iters=s["sinkhorn_iters"],
                           match_threshold=s["match_threshold"])


def draw_superpoint(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """SuperPoint's weights in the port's (``superpoint_v1.pth``'s) key
    layout, from ``seed``."""
    from avlmaps_torch.models.superpoint import SuperPointNet

    shapes = {k: tuple(v.shape) for k, v in SuperPointNet(
        superpoint_config(cfg), device="meta").state_dict().items()}
    return weights.draw(shapes, _sp_rule, seed, device, torch.float32)


def draw_superglue(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """SuperGlue's weights in the port's key layout (BatchNorm folded),
    from ``seed + 1``."""
    from avlmaps_torch.models.superglue import SuperGlueNet

    shapes = {k: tuple(v.shape) for k, v in SuperGlueNet(
        superglue_config(cfg), device="meta").state_dict().items()}
    return weights.draw(shapes, _sg_rule, seed + 1, device, torch.float32)


def superpoint(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    from avlmaps_torch.models.superpoint import SuperPointExtractor

    return SuperPointExtractor(superpoint_config(cfg), params=sd,
                               device=device)


def superglue(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    from avlmaps_torch.models.superglue import SuperGlueMatcher

    return SuperGlueMatcher(superglue_config(cfg), params=sd, device=device)


def clip_text(cfg: Dict) -> Dict:
    """The retrieval tower's ``text`` block: the one of the configuration
    named in ``retrieval``, with a ``text`` given to this configuration
    (an override) laid over it."""
    base = registry.config(cfg["retrieval"]["config"])["text"]
    over = cfg.get("text", {})
    out = dict(base, **{k: v for k, v in over.items() if k != "vision"})
    out["vision"] = dict(base["vision"], **over.get("vision", {}))
    return out


def draw_clip(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """CLIP's weights, from ``seed + 2``."""
    return clip.draw(clip_text(cfg), seed + 2, device)


def clip_encoder(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    return clip.encoder(clip_text(cfg), sd, device)


# -- operation and byte counts ---------------------------------------------

def _propagation_flops(d: int, n: int, m: int) -> int:
    """One attentional propagation of ``n`` keypoints over ``m`` sources:
    q and merge on n, k and v on m, scores and the weighted sum over all
    heads, the 2d -> 2d -> d MLP on [x, message]."""
    return (2 * roofline.linear_flops(n, d, d) + 2 * roofline.linear_flops(
        m, d, d) + 4 * n * m * d + roofline.linear_flops(n, 2 * d, 2 * d)
        + roofline.linear_flops(n, 2 * d, d))


def gnn_flops(cfg: Dict, k0: int, k1: int) -> int:
    """The keypoint encoder, the 2 x gnn_layers propagations of both sets,
    the final projection and the (K0, K1) scores."""
    s = cfg["superglue"]
    d = s["desc_dim"]
    widths = [3] + list(s["kenc_layers"]) + [d]
    enc = sum(roofline.linear_flops(1, a, b)
              for a, b in zip(widths[:-1], widths[1:]))
    f = (k0 + k1) * enc
    for _ in range(s["gnn_layers"]):
        f += _propagation_flops(d, k0, k0) + _propagation_flops(d, k1, k1)
        f += _propagation_flops(d, k0, k1) + _propagation_flops(d, k1, k0)
    f += roofline.linear_flops(k0 + k1, d, d)
    return f + roofline.linear_flops(k0, d, k1)


def gnn_bytes(cfg: Dict, k0: int, k1: int) -> int:
    """The least bytes: every weight read once (f32), both sets' inputs
    (xy, score, descriptor) read once and the (K0, K1) scores written
    once."""
    from avlmaps_torch.models.superglue import SuperGlueNet

    params = sum(v.numel() for v in SuperGlueNet(
        superglue_config(cfg), device="meta").state_dict().values())
    d = cfg["superglue"]["desc_dim"]
    return 4 * (params + (k0 + k1) * (3 + d) + k0 * k1)


def sinkhorn_bytes(cfg: Dict, k0: int, k1: int) -> int:
    """The least bytes of the log-domain Sinkhorn: one f32 read of the
    (K0 + 1) x (K1 + 1) coupling per half-update (two a iteration) and
    the final write of Z."""
    coupling = 4 * (k0 + 1) * (k1 + 1)
    return (2 * cfg["superglue"]["sinkhorn_iters"] + 1) * coupling
