"""Weights for the port's SuperPoint.

- ``load_superpoint_checkpoint(path)``: MagicLeap's ``superpoint_v1.pth``
  (a flat state dict: ``conv1a`` .. ``conv4b``, ``convPa``/``convPb``,
  ``convDa``/``convDb``, each ``.weight`` (out, in, kh, kw) and
  ``.bias``) -> ``(SuperPointConfig, state_dict)``.  The module carries
  the checkpoint's names, so the tensors load as they are.
- ``params_from_flax(tree)``: the JAX package's SuperPoint variables
  (``{"params": {name: {"kernel" (kh, kw, in, out), "bias"}}}``) -> this
  package's state_dict.
- ``init_params(cfg, generator)``: seeded weights at any width.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from avlmaps_torch.models.superpoint.model import (LAYERS, SuperPointConfig,
                                                   SuperPointNet)


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x, np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def config_from_state_dict(sd: Mapping[str, Any]) -> SuperPointConfig:
    """The widths of a ``superpoint_v1.pth``-layout state dict."""
    def out(name):
        return _np(sd[f"{name}.weight"]).shape[0]

    return SuperPointConfig(
        channels=tuple(out(f"conv{i}a") for i in range(1, 5)),
        det_ch=out("convPa"), desc_ch=out("convDa"), desc_dim=out("convDb"))


def port_superpoint_state_dict(sd: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """A ``superpoint_v1.pth``-layout state dict -> this package's
    state_dict (f32 CPU tensors; other keys dropped)."""
    return {f"{name}.{leaf}": _tensor(_np(sd[f"{name}.{leaf}"]))
            for name in LAYERS for leaf in ("weight", "bias")}


def load_superpoint_checkpoint(path: str) -> Tuple[SuperPointConfig,
                                                   Dict[str, torch.Tensor]]:
    """``superpoint_v1.pth`` -> ``(config, state_dict)`` for
    :class:`SuperPointExtractor`."""
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return config_from_state_dict(sd), port_superpoint_state_dict(sd)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SuperPoint variables -> this package's state_dict
    (conv kernels (kh, kw, in, out) -> (out, in, kh, kw))."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    for name in LAYERS:
        out[f"{name}.weight"] = _tensor(
            _np(params[name]["kernel"]).transpose(3, 2, 0, 1))
        out[f"{name}.bias"] = _tensor(_np(params[name]["bias"]))
    return out


def init_params(cfg: SuperPointConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` on the generator's device, with flax's
    default initialisers' scale: conv weights N(0, 1/fan_in), biases 0."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, meta in SuperPointNet(cfg, device="meta").state_dict().items():
        shape = tuple(meta.shape)
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev) \
                / math.sqrt(math.prod(shape[1:]))
    return out
