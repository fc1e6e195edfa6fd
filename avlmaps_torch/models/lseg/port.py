"""Weight bridge for the port's LSegNet, and seeded random weights.

``params_from_flax`` turns the JAX package's LSeg variables -- a nested
dict of arrays, ``{"params": {"backbone": ..., "decoder": ...,
"head1": ...}}`` as ``avlmaps_tpu.models.lseg.port_lseg_state_dict`` or
``LSegNet.init`` produce -- into this package's ``state_dict``, which
``LSegNet.load_state_dict(..., strict=True)`` accepts.  Layout changes:
Dense ``(in, out)`` -> Linear ``(out, in)``; Conv ``(kh, kw, cin, cout)``
-> ``(cout, cin, kh, kw)``; flax ConvTranspose ``(kh, kw, in, out)`` ->
torch ``(in, out, kh, kw)`` with the spatial axes mirrored (flax's
default kernel convention is torch's flipped); LayerNorm ``scale`` ->
``weight``.

``load_lseg_checkpoint`` reads the reference's Lightning checkpoint
(``demo_e200.ckpt``) into this package's state_dict: it carries over the
JAX package's porter (``port_lseg_state_dict``: prefix strip, BatchNorm
folded into the preceding convs, refinenet4's unused branch dropped) to
the flax layout, then ``params_from_flax``.

``init_params`` draws random weights for a config from a
``torch.Generator`` (real LSeg weights are not part of the repository).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from avlmaps_torch.models.lseg.model import LSegConfig, LSegNet

_INDEXED = re.compile(r"^(block|reassemble|scratch)_(\d+)$")
_REFINE = re.compile(r"^refinenet(\d)$")
_CONTAINER = {"block": "blocks", "reassemble": "reassemble",
              "scratch": "scratch"}


def _module_path(keys) -> str:
    out = []
    for k in keys:
        m = _INDEXED.match(k)
        r = _REFINE.match(k)
        if m:
            out += [_CONTAINER[m.group(1)], m.group(2)]
        elif r:
            out += ["refinenet", str(int(r.group(1)) - 1)]
        else:
            out.append(k)
    return ".".join(out)


def _convert(keys, leaf: np.ndarray):
    """(torch param name, array) for one flax leaf."""
    name, arr = keys[-1], np.asarray(leaf, np.float32)
    prefix = _module_path(keys[:-1])
    if name in ("cls_token", "pos_embed"):
        return prefix + "." + name if prefix else name, arr
    if name == "scale":
        return prefix + ".weight", arr
    if name == "bias":
        return prefix + ".bias", arr
    if name != "kernel":
        raise KeyError(f"unexpected flax leaf {'/'.join(keys)}")
    if arr.ndim == 2:  # Dense
        w = arr.T
    elif keys[-2] == "resample" and keys[-3] in ("reassemble_0",
                                                  "reassemble_1"):
        # ConvTranspose
        w = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    else:  # Conv
        w = arr.transpose(3, 2, 0, 1)
    return prefix + ".weight", np.ascontiguousarray(w)


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x,
                      np.float32)


def _conv(sd, key: str) -> Dict[str, np.ndarray]:
    """torch Conv2d (out,in,kh,kw) -> flax Conv kernel (kh,kw,in,out)."""
    out = {"kernel": _t(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _convT(sd, key: str) -> Dict[str, np.ndarray]:
    """torch ConvTranspose2d (in,out,kh,kw) -> flax ConvTranspose
    (kh,kw,in,out).  flax's default (transpose_kernel=False) convention is
    spatially mirrored relative to torch's, so flip kh/kw (verified
    numerically in tests/test_lseg.py)."""
    w = _t(sd[f"{key}.weight"])[:, :, ::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1))}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _dense(sd, key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _ln(sd, key: str) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])}


def _conv_fold_bn(sd, conv_key: str, bn_key: str,
                  eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Fold BatchNorm running stats into the conv:
    w' = w * gamma/sqrt(var+eps) (per out-channel), b' = beta - mean*scale."""
    w = _t(sd[f"{conv_key}.weight"])  # (out, in, kh, kw)
    gamma = _t(sd[f"{bn_key}.weight"])
    beta = _t(sd[f"{bn_key}.bias"])
    mean = _t(sd[f"{bn_key}.running_mean"])
    var = _t(sd[f"{bn_key}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    w = w * scale[:, None, None, None]
    b = beta - mean * scale
    if f"{conv_key}.bias" in sd:
        b = b + _t(sd[f"{conv_key}.bias"]) * scale
    return {"kernel": w.transpose(2, 3, 1, 0), "bias": b}


def strip_net_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip a leading 'net.' from every key (the intent of the reference's
    buggy lstrip at vlmap_builder.py:248)."""
    return {(k[4:] if k.startswith("net.") else k): v for k, v in sd.items()}


def _rcu(sd, prefix: str, has_bn: bool) -> Dict[str, Any]:
    if has_bn:
        return {
            "conv1": _conv_fold_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
            "conv2": _conv_fold_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2"),
        }
    return {"conv1": _conv(sd, f"{prefix}.conv1"),
            "conv2": _conv(sd, f"{prefix}.conv2")}


def port_lseg_state_dict(sd: Dict[str, Any], vit_layers: int = 24,
                         use_bn: bool = True) -> Dict[str, Any]:
    """LSeg torch state dict (prefix-stripped) -> flax params tree for
    :class:`the JAX package's LSegNet (``params_from_flax`` takes it on
    to this package's state_dict)`."""
    sd = strip_net_prefix(sd)

    backbone: Dict[str, Any] = {
        "patch_embed": _conv(sd, "pretrained.model.patch_embed.proj"),
        "cls_token": _t(sd["pretrained.model.cls_token"]).reshape(1, 1, -1),
        "pos_embed": _t(sd["pretrained.model.pos_embed"]),
    }
    for i in range(vit_layers):
        p = f"pretrained.model.blocks.{i}"
        if f"{p}.norm1.weight" not in sd:
            break
        backbone[f"block_{i}"] = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "qkv": _dense(sd, f"{p}.attn.qkv"),
            "proj": _dense(sd, f"{p}.attn.proj"),
            "mlp_fc": _dense(sd, f"{p}.mlp.fc1"),
            "mlp_proj": _dense(sd, f"{p}.mlp.fc2"),
        }

    decoder: Dict[str, Any] = {}
    # act_postprocess indices: [0]=readout project, [3]=1x1 conv, [4]=resample
    for lvl in range(4):
        ap = f"pretrained.act_postprocess{lvl + 1}"
        entry: Dict[str, Any] = {
            "readout": {"project": _dense(sd, f"{ap}.0.project.0")},
            "proj": _conv(sd, f"{ap}.3"),
        }
        if lvl in (0, 1):
            entry["resample"] = _convT(sd, f"{ap}.4")
        elif lvl == 3:
            entry["resample"] = _conv(sd, f"{ap}.4")
        decoder[f"reassemble_{lvl}"] = entry
        decoder[f"scratch_{lvl}"] = _conv(sd, f"scratch.layer{lvl + 1}_rn")

    for r in range(1, 5):
        p = f"scratch.refinenet{r}"
        entry = {
            "rcu2": _rcu(sd, f"{p}.resConfUnit2", use_bn),
            "out_conv": _conv(sd, f"{p}.out_conv"),
        }
        if r != 4:
            # refinenet4 is called with ONE input (lseg_net.py:296-306:
            # path_4 = refinenet4(layer_4_rn)), so its resConfUnit1 branch
            # never runs; the checkpoint carries those weights but the
            # flax decoder has no module for them — drop, don't port.
            entry["rcu1"] = _rcu(sd, f"{p}.resConfUnit1", use_bn)
        decoder[f"refinenet{r}"] = entry

    return {"params": {
        "backbone": backbone,
        "decoder": decoder,
        "head1": _conv(sd, "scratch.head1"),
    }}


def load_lseg_checkpoint(path: str,
                         vit_layers: int = None) -> Dict[str, torch.Tensor]:
    """The reference's LSeg Lightning checkpoint -> this package's
    state_dict.  ``vit_layers`` defaults to the block count found in the
    checkpoint (24 for the real ViT-L file)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if vit_layers is None:
        blocks = {k.split(".")[4] for k in sd
                  if k.startswith("net.pretrained.model.blocks.")}
        vit_layers = len(blocks) or 24
    return params_from_flax(port_lseg_state_dict(sd, vit_layers=vit_layers))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's LSeg variables -> this package's state_dict (f32
    CPU tensors)."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node, keys):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, keys + [str(k)])
            return
        name, arr = _convert(keys, node)
        out[name] = torch.from_numpy(arr.copy())

    walk(params, [])
    return out


def init_params(cfg: LSegConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``cfg`` as a state_dict on the
    generator's device: LayerNorm scale 1 and bias 0, other biases and the
    cls token 0, pos-embed N(0, 0.02²), kernels N(0, 1/fan_in) (the scale
    of flax's lecun-normal init)."""
    shapes = LSegNet(cfg, device="meta").state_dict()
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        if name.endswith("pos_embed"):
            t = torch.randn(shape, generator=generator, device=dev) * 0.02
        elif name.endswith("bias") or name.endswith("cls_token"):
            t = torch.zeros(shape, device=dev)
        elif len(shape) == 1:  # LayerNorm scale
            t = torch.ones(shape, device=dev)
        else:
            fan_in = math.prod(shape[1:])
            if re.match(r"decoder\.reassemble\.[01]\.resample\.", name):
                fan_in = shape[0]  # transposed conv: (in, out, kh, kw)
            t = torch.randn(shape, generator=generator, device=dev)
            t *= 1.0 / math.sqrt(fan_in)
        out[name] = t
    return out
