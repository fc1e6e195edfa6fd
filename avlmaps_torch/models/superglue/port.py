"""Weights for the port's SuperGlue.

- ``load_superglue_checkpoint(path)``: public ``superglue_{indoor,
  outdoor}.pth`` -> ``(SuperGlueConfig, state_dict)``.  The torch layout
  (what the reference consumes through HLoc, avlmaps/utils/
  localization_utils.py:140-145) is Conv1d / BatchNorm1d Sequentials;
  inference-mode BatchNorm is an affine map, so each BN is folded into
  its preceding layer: ``W' = W * gamma/std``, ``b' = (b - mean) *
  gamma/std + beta`` (the JAX package's ``port.py:26-41``).
- ``params_from_flax(tree)``: the JAX package's SuperGlue variables ->
  this package's state_dict (Dense ``(in, out)`` -> Linear ``(out,
  in)``, ``g<i>`` -> ``gnn.<i>``).
- ``init_params(cfg, generator)``: seeded weights at any width.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from avlmaps_torch.models.superglue.model import SuperGlueConfig, SuperGlueNet

_LAYERS = ("q", "k", "v", "merge", "mlp0", "mlp1")


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x, np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def _dense(sd: Mapping[str, Any], conv: str, bn: Optional[str] = None,
           eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Conv1d (+ folded BN) -> Linear (weight (out, in), bias (out,))."""
    w = _np(sd[f"{conv}.weight"])[:, :, 0]
    b = _np(sd[f"{conv}.bias"])
    if bn is not None:
        scale = _np(sd[f"{bn}.weight"]) / np.sqrt(
            _np(sd[f"{bn}.running_var"]) + eps)
        w = w * scale[:, None]
        b = (b - _np(sd[f"{bn}.running_mean"])) * scale \
            + _np(sd[f"{bn}.bias"])
    return w, b


def config_from_state_dict(sd: Mapping[str, Any], heads: int = 4,
                           sinkhorn_iters: int = 100) -> SuperGlueConfig:
    """The SuperGlueConfig of a checkpoint's tensor shapes.  The Sinkhorn
    runs MagicLeap's 100 iterations, what the reference pipeline runs
    with; a smaller count is an explicit speed knob."""
    desc_dim = _np(sd["final_proj.weight"]).shape[0]
    enc_idx = sorted({int(m.group(1)) for k in sd
                      if (m := re.match(r"kenc\.encoder\.(\d+)\.weight$",
                                        k))})
    # conv positions are 0, 3, 6, ...; BN positions are conv + 1
    convs = [i for i in enc_idx if i % 3 == 0]
    kenc_layers = tuple(_np(sd[f"kenc.encoder.{i}.weight"]).shape[0]
                        for i in convs[:-1])
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"gnn\.layers\.(\d+)\.", k)))
    return SuperGlueConfig(desc_dim=desc_dim, kenc_layers=kenc_layers,
                           gnn_layers=n_layers // 2, heads=heads,
                           sinkhorn_iters=sinkhorn_iters)


def port_superglue_state_dict(sd: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A torch-layout SuperGlue state dict -> this package's state_dict,
    BatchNorm folded (f32 CPU tensors)."""
    cfg = config_from_state_dict(sd)
    out: Dict[str, torch.Tensor] = {}

    def put(name, pair):
        out[f"{name}.weight"], out[f"{name}.bias"] = map(_tensor, pair)

    n_stages = len(cfg.kenc_layers) + 1
    for j in range(n_stages):
        bn = f"kenc.encoder.{3 * j + 1}" if j < n_stages - 1 else None
        put(f"kenc.enc{j}", _dense(sd, f"kenc.encoder.{3 * j}", bn))
    for i in range(2 * cfg.gnn_layers):
        base = f"gnn.layers.{i}"
        for name, conv, bn in (("q", "attn.proj.0", None),
                               ("k", "attn.proj.1", None),
                               ("v", "attn.proj.2", None),
                               ("merge", "attn.merge", None),
                               ("mlp0", "mlp.0", "mlp.1"),
                               ("mlp1", "mlp.3", None)):
            put(f"gnn.{i}.{name}", _dense(
                sd, f"{base}.{conv}", bn and f"{base}.{bn}"))
    put("final_proj", _dense(sd, "final_proj"))
    out["bin_score"] = _tensor(_np(sd["bin_score"]).reshape(()))
    return out


def load_superglue_checkpoint(path: str, sinkhorn_iters: int = 100
                              ) -> Tuple[SuperGlueConfig,
                                         Dict[str, torch.Tensor]]:
    """``superglue_*.pth`` -> ``(config, state_dict)`` for
    :class:`SuperGlueMatcher` (100 Sinkhorn iterations unless asked)."""
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return (config_from_state_dict(sd, sinkhorn_iters=sinkhorn_iters),
            port_superglue_state_dict(sd))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SuperGlue variables -> this package's state_dict
    (f32 CPU tensors)."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def put(name, node):
        out[f"{name}.weight"] = _tensor(_np(node["kernel"]).T)
        out[f"{name}.bias"] = _tensor(_np(node["bias"]))

    for j, node in params["kenc"].items():
        put(f"kenc.{j}", node)
    for key, node in params.items():
        m = re.match(r"^g(\d+)$", key)
        if m:
            for name in _LAYERS:
                put(f"gnn.{m.group(1)}.{name}", node[name])
    put("final_proj", params["final_proj"])
    out["bin_score"] = _tensor(_np(params["bin_score"]).reshape(()))
    return out


def init_params(cfg: SuperGlueConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` on the generator's device, with the JAX
    package's initialisers' scale: Linear weights N(0, 1/fan_in), biases
    0, the dustbin score 1."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, meta in SuperGlueNet(cfg, device="meta").state_dict().items():
        shape = tuple(meta.shape)
        if name == "bin_score":
            out[name] = torch.tensor(1.0, device=dev)
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=dev)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev) \
                / math.sqrt(shape[1])
    return out
