"""Weights for the port's NetVLAD.

- ``load_netvlad_mat(path)``: the matconvnet VGG16-NetVLAD-Pitts30K
  ``.mat`` that HLoc distributes (read with scipy, ``simplify_cells``)
  -> ``(state_dict, average_image, NetVLADConfig)``, with the JAX
  package's rules (``avlmaps_tpu/models/netvlad/port.py``): ``conv*``
  layers fill ``backbone.conv_<i>`` in order (kernels HWIO ->
  OIHW), the VLAD core's soft-assignment 1x1 conv fills ``assign`` and
  its centres, stored NEGATED in the file (hloc: ``center_w =
  -weights[1]``), fill ``centers``; the WPCA layer fills ``whiten``;
  ``net.meta.normalization.averageImage`` is the input mean.
- ``params_from_flax(tree)``: the JAX package's NetVLAD variables -> this
  package's state_dict.
- ``init_params(cfg, generator)``: seeded weights at any width, the
  soft assignment initialised from the centres as NetVLAD does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.models.netvlad.model import (NetVLAD, NetVLADConfig,
                                                NetVLADEncoder)


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x, np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def _as_list(layers):
    if isinstance(layers, np.ndarray) and layers.dtype == object:
        return list(layers)  # matconvnet cell array
    return layers if isinstance(layers, (list, tuple)) else [layers]


def weighted_layers(net) -> list:
    """The matconvnet ``net``'s layers that carry weights, in order
    (relu and pool layers carry none)."""
    return [layer for layer in _as_list(net["layers"])
            if isinstance(layer, dict) and layer.get("weights") is not None]


def load_netvlad_mat(path: str) -> Tuple[Dict[str, torch.Tensor],
                                         np.ndarray, NetVLADConfig]:
    """Read the matconvnet file -> (state_dict, average_image, config)."""
    from scipy.io import loadmat

    net = loadmat(str(path), simplify_cells=True)["net"]
    convs = []
    assign = centers = whiten = None
    for layer in weighted_layers(net):
        name = str(layer.get("name", ""))
        w = [np.asarray(x, np.float32) for x in _as_list(layer["weights"])]
        bias = w[1].reshape(-1) if len(w) > 1 else None
        if name.startswith("conv"):
            convs.append((w[0], bias))
        elif "vlad" in name.lower():
            # [assignment kernel (1, 1, D, K) or (D, K), (bias,) centres]
            a = w[0].reshape(-1, w[0].shape[-1])  # (D, K)
            assign = (a, w[1].reshape(-1) if w[1].ndim == 1 else None)
            cen = w[-1]
            if assign[1] is None and len(w) >= 3:
                assign, cen = (a, w[1].reshape(-1)), w[2]
            centers = cen if cen.shape[0] == a.shape[0] else cen.T  # (D, K)
        elif name.lower().startswith(("wpca", "whit", "postl2_wpca")):
            whiten = (w[0].reshape(-1, w[0].shape[-1]), bias)
    if not convs or assign is None or centers is None or whiten is None:
        raise ValueError(
            f"unrecognised NetVLAD .mat layout: convs={len(convs)}, "
            f"vlad={'ok' if assign is not None else 'missing'}, "
            f"whiten={'ok' if whiten is not None else 'missing'}")

    k = assign[0].shape[-1]
    cfg = NetVLADConfig(clusters=k, dim=convs[-1][0].shape[-1],
                        whiten_dim=whiten[0].shape[-1])
    sd: Dict[str, torch.Tensor] = {}
    for i, (kernel, bias) in enumerate(convs):
        sd[f"backbone.conv_{i}.weight"] = _tensor(kernel.transpose(3, 2, 0,
                                                                   1))
        sd[f"backbone.conv_{i}.bias"] = _tensor(bias)
    sd["assign.weight"] = _tensor(assign[0].T)
    sd["assign.bias"] = _tensor(assign[1] if assign[1] is not None
                                else np.zeros(k, np.float32))
    sd["centers"] = _tensor(-centers.T)  # (K, D); the file negates them
    sd["whiten.weight"] = _tensor(whiten[0].T)
    sd["whiten.bias"] = _tensor(whiten[1] if whiten[1] is not None
                                else np.zeros(cfg.whiten_dim, np.float32))

    avg = np.zeros(3, np.float32)
    meta = net.get("meta") if isinstance(net, dict) else None
    if isinstance(meta, dict):
        norm = meta.get("normalization")
        if isinstance(norm, dict) and "averageImage" in norm:
            avg = np.asarray(norm["averageImage"],
                             np.float32).reshape(-1, 3).mean(axis=0)
    return sd, avg, cfg


def load_netvlad_encoder(path: str, device: Union[str, torch.device] = "cuda"
                         ) -> NetVLADEncoder:
    """One-call loader: ``.mat`` -> a ready :class:`NetVLADEncoder`."""
    sd, avg, cfg = load_netvlad_mat(path)
    return NetVLADEncoder(cfg, params=sd, average_image=avg, device=device)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's NetVLAD variables -> this package's state_dict
    (conv kernels (kh, kw, in, out) -> (out, in, kh, kw), Dense (in, out)
    -> Linear (out, in))."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params["backbone"].items():
        sd[f"backbone.{name}.weight"] = _tensor(
            _np(node["kernel"]).transpose(3, 2, 0, 1))
        sd[f"backbone.{name}.bias"] = _tensor(_np(node["bias"]))
    for name in ("assign", "whiten"):
        sd[f"{name}.weight"] = _tensor(_np(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = _tensor(_np(params[name]["bias"]))
    sd["centers"] = _tensor(_np(params["centers"]))
    return sd


# the sharpness of the seeded soft assignment (NetVLAD's alpha)
INIT_ALPHA = 100.0


def init_params(cfg: NetVLADConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` on the generator's device: conv and
    whitening weights N(0, 1/fan_in), biases 0; centres N(0, 1/D) (unit
    norm in expectation, like k-means centres of the unit local
    descriptors) and the soft assignment NetVLAD initialises from them,
    ``w = 2 alpha c``, ``b = -alpha |c|^2`` (the form matconvnet's VLAD
    layer encodes).  With the JAX package's initialisers (centres N(0, 1),
    a random assignment) every residual is dominated by its centre and
    every image gets nearly the same descriptor (distinct 720x1080 frames
    agree to six decimals in cosine on the card), and retrieval is decided
    by rounding."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, meta in NetVLAD(cfg, device="meta").state_dict().items():
        shape = tuple(meta.shape)
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev) \
                / math.sqrt(math.prod(shape[1:]) if name != "centers"
                            else cfg.dim)
    c = out["centers"]
    out["assign.weight"] = 2.0 * INIT_ALPHA * c
    out["assign.bias"] = -INIT_ALPHA * (c * c).sum(dim=1)
    return out
