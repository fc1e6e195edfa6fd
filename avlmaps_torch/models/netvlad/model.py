"""NetVLAD global image descriptor (VGG16 to conv5_3 + a VLAD head).

Counterpart of ``avlmaps_tpu/models/netvlad/model.py``.  The reference
retrieves mapping frames with HLoc's "VGG16-NetVLAD-Pitts30K" global
descriptors (avlmaps/utils/localization_utils.py:134-136, 310-447);
matconvnet's ``vd16_pitts30k_conv5_3_vlad_preL2_intra_white``:

* VGG16 conv1_1 .. conv5_3 (13 3x3 convs, 4 max-pools), ReLU after every
  conv but the last: conv5_3's raw activations are the D = 512 local
  descriptors;
* pre-L2 over channels; soft assignment (a 1x1 conv D -> K = 64 and a
  softmax); VLAD residual sums against the learned centres; intra-
  normalisation per cluster, flatten to K*D = 32,768, global L2;
* whitening: an affine projection 32,768 -> 4,096 and a final L2.

Inputs are RGB in [0, 255] minus the checkpoint's average image.  The
network runs NCHW in f32 under ``full_f32`` (no TF32 in the convolutions
or the whitening product).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.utils.device import full_f32, resolve_device, to_device

# VGG16's conv channels up to conv5_3; "M" = 2x2/2 max-pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)


@dataclasses.dataclass(frozen=True)
class NetVLADConfig:
    clusters: int = 64
    dim: int = 512  # conv5_3 channels
    whiten_dim: int = 4096

    @staticmethod
    def tiny() -> "NetVLADConfig":
        return NetVLADConfig(clusters=4, dim=32, whiten_dim=16)

    def plan(self):
        """The full VGG16 plan at dim 512, else the JAX package's
        two-conv test plan."""
        return VGG16_PLAN if self.dim == 512 else (self.dim, "M", self.dim)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class VGGBackbone(nn.Module):
    """VGG16 conv stack up to conv5_3, no ReLU on the last conv."""

    def __init__(self, cfg: NetVLADConfig):
        super().__init__()
        self.plan = cfg.plan()
        cin, i = 3, 0
        for p in self.plan:
            if p != "M":
                setattr(self, f"conv_{i}", nn.Conv2d(cin, int(p), 3,
                                                     padding=1))
                cin, i = int(p), i + 1
        self.n_convs = i

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for p in self.plan:
            if p == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, f"conv_{i}")(x)
            i += 1
            if i < self.n_convs:
                x = F.relu(x)
        return x


class NetVLAD(nn.Module):
    """Backbone + VLAD aggregation + whitening, parameters on ``device``
    (``"meta"`` for shapes only)."""

    def __init__(self, cfg: NetVLADConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.backbone = VGGBackbone(cfg)
            self.assign = nn.Linear(cfg.dim, cfg.clusters)
            self.centers = nn.Parameter(torch.zeros(cfg.clusters, cfg.dim))
            self.whiten = nn.Linear(cfg.clusters * cfg.dim, cfg.whiten_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) f32, RGB in [0, 255] minus the average image ->
        (B, whiten_dim) L2-normalised."""
        with full_f32():
            x = self.backbone(images.permute(0, 3, 1, 2).float())
            b, d = x.shape[:2]
            x = _l2(x.flatten(2).transpose(1, 2))  # (B, N, D), pre-L2
            assign = torch.softmax(self.assign(x), dim=-1)  # (B, N, K)
            # vlad[k] = sum_n a[n, k] (x[n] - c[k])
            vlad = torch.einsum("bnk,bnd->bkd", assign, x) \
                - assign.sum(dim=1)[..., None] * self.centers[None]
            vlad = _l2(_l2(vlad).reshape(b, self.cfg.clusters * d))
            return _l2(self.whiten(vlad))


class NetVLADEncoder:
    """NetVLAD on ``device`` (default ``"cuda"``; raises without a card)
    with the retrieval interface of ``ClipEncoder`` (``feat_dim``,
    ``get_img_feats``, ``get_imgs_feats_batch``), so it drops into the
    visual map's retrieval.

    ``params`` is a state_dict of :class:`NetVLAD` (``port.
    params_from_flax`` or ``port.load_netvlad_mat``); ``params=None``
    draws seeded random weights at ``cfg``'s width.  ``average_image``:
    the RGB mean subtracted from every input."""

    def __init__(self, cfg: NetVLADConfig = NetVLADConfig(), params=None,
                 average_image: Optional[np.ndarray] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from avlmaps_torch.models.netvlad.port import init_params

        self.cfg = cfg
        self.device = resolve_device(device)
        self.average_image = (
            np.zeros(3, np.float32) if average_image is None
            else np.asarray(average_image, np.float32).reshape(-1)[:3])
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen)
        self.model = NetVLAD(cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @property
    def feat_dim(self) -> int:
        return self.cfg.whiten_dim

    def _prep(self, images: Sequence[np.ndarray]) -> np.ndarray:
        arr = np.stack([np.asarray(im, np.float32) for im in images])
        return arr - self.average_image  # RGB [0, 255] minus the means

    @torch.no_grad()
    def encode_device(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """Descriptors of same-sized HWC RGB images, on the device."""
        return self.model(to_device(self._prep(images), self.device))

    def get_img_feats(self, image: np.ndarray) -> np.ndarray:
        return self.encode_device([image]).cpu().numpy()

    def get_imgs_feats_batch(self, images: Sequence[np.ndarray],
                             batch_size: int = 16) -> np.ndarray:
        return np.concatenate([
            self.encode_device(images[s:s + batch_size]).cpu().numpy()
            for s in range(0, len(images), batch_size)])
