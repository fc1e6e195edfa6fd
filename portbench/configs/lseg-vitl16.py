"""lseg-vitl16: the map-build encoder (LSeg ViT-L/16, bf16) and the query
text tower (CLIP ViT-B/32's, f32): seeded weights, the port's networks
built from them, and the operation counts from the widths."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.bench import clip, roofline, weights


def _lseg_rule(name: str, shape):
    if name.endswith(("cls_token", "pos_embed")) or name.endswith(".bias"):
        return 0.0, 0.02
    if len(shape) == 1:  # LayerNorm scale
        return 1.0, 0.02
    fan = weights.fan_in(shape)
    if ".resample." in name and name.startswith(("decoder.reassemble.0",
                                                 "decoder.reassemble.1")):
        fan = shape[0]  # transposed conv: (in, out, kh, kw)
    return 0.0, fan ** -0.5


def port_lseg_config(enc: Dict):
    from avlmaps_torch.models.lseg import LSegConfig
    from avlmaps_torch.models.lseg.vit import DenseViTConfig

    dt = getattr(torch, enc["dtype"])
    return LSegConfig(
        vit=DenseViTConfig(patch_size=enc["patch"], width=enc["width"],
                           layers=enc["layers"], heads=enc["heads"],
                           mlp_ratio=enc["mlp_ratio"],
                           hooks=tuple(enc["hooks"]),
                           pretrain_grid=enc["pretrain_grid"], dtype=dt),
        features=enc["features"], reassemble_ch=tuple(enc["reassemble_ch"]),
        out_dim=enc["out_dim"], dtype=dt)


def draw_lseg(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The encoder's weights in the port's state-dict layout."""
    from avlmaps_torch.models.lseg import LSegNet

    shapes = {k: tuple(v.shape) for k, v in
              LSegNet(port_lseg_config(cfg["encoder"]), device="meta")
              .state_dict().items()}
    return weights.draw(shapes, _lseg_rule, seed, device,
                        getattr(torch, cfg["encoder"]["dtype"]))


def lseg_net(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    """The port's LSegNet holding ``sd``, cast for inference as the
    builders run it."""
    from avlmaps_torch.models.lseg import LSegNet, cast_params_for_inference

    pc = port_lseg_config(cfg["encoder"])
    net = LSegNet(pc, device=device)
    net.load_state_dict(sd, strict=True)
    if pc.dtype == torch.bfloat16:
        cast_params_for_inference(net)
    return net.eval().requires_grad_(False)


def reference_spec(cfg: Dict) -> Dict:
    e = cfg["encoder"]
    return {k: e[k] for k in ("patch", "width", "heads", "hooks",
                              "pretrain_grid", "out_dim")}


def draw_clip(text: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return clip.draw(text, seed, device)


def clip_encoder(text: Dict, sd: Dict[str, torch.Tensor], device):
    return clip.encoder(text, sd, device)


# -- operation counts -------------------------------------------------------

def crops_per_frame(cfg: Dict) -> int:
    from portbench.reference.vlmap import plan_windows

    m = cfg["map"]
    h, w = m["image_hw"]
    return len(plan_windows(h, w, m["lseg_base_size"],
                            m["lseg_crop_size"])[4])


def vit_crop_flops(cfg: Dict) -> int:
    e = cfg["encoder"]
    g = cfg["map"]["lseg_crop_size"] // e["patch"]
    n_blocks = max(e["hooks"]) + 1  # blocks past the last hook never run
    return roofline.vit_flops(1 + g * g, e["width"], n_blocks,
                              e["mlp_ratio"], e["patch"] ** 2 * 3)


def vit_crop_bytes(cfg: Dict, crops_per_forward: int) -> float:
    """A forward's weights once, shared by its crops, plus each crop's
    input image (f32) and its four taps (the served dtype)."""
    e = cfg["encoder"]
    db = roofline.DTYPE_BYTES[e["dtype"]]
    g = cfg["map"]["lseg_crop_size"] // e["patch"]
    wb = roofline.vit_weight_bytes(e["width"], max(e["hooks"]) + 1,
                                   e["mlp_ratio"], db)
    crop = cfg["map"]["lseg_crop_size"]
    io = crop * crop * 3 * 4 + 4 * (1 + g * g) * e["width"] * db
    return wb / crops_per_forward + io


def decoder_crop_flops(cfg: Dict) -> int:
    e = cfg["encoder"]
    g = cfg["map"]["lseg_crop_size"] // e["patch"]
    return roofline.dpt_head_flops(g, e["width"], e["reassemble_ch"],
                                   e["features"], e["out_dim"])


def frame_flops(cfg: Dict) -> int:
    """Model operations a frame of the sliding build: its crops through
    the ViT, the decoder and the head."""
    return crops_per_frame(cfg) * (vit_crop_flops(cfg)
                                   + decoder_crop_flops(cfg))


def peak_flops(cfg: Dict) -> float:
    return roofline.PEAK_FLOPS[cfg["encoder"]["dtype"]]
