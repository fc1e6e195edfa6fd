"""Port the reference's downloaded checkpoints into the port's parameter
files.

Counterpart of ``tools/port_checkpoints.py``, with its flags:

    python -m avlmaps_torch.tools.port_checkpoints --lseg demo_e200.ckpt \\
        --clip ViT-B-32.pt --audioclip AudioCLIP-Partial-Training.pt \\
        --superpoint superpoint_v1.pth --superglue superglue_indoor.pth \\
        --wav2clip wav2clip.pt --netvlad Pitts30K_struct.mat --out ported/

Each checkpoint is first diffed against its manifest
(``tools/ckpt_manifests/``, :mod:`avlmaps_torch.tools.ckpt_manifest`),
so structural drift is reported as a summary instead of a loader's
``KeyError`` (``--strict-manifest`` fails on it).  The port's loader
then converts it, the result is strict-loaded into the port's module at
release scale on ``--device`` (default ``cuda``; raises without a card),
and ``<name>.pt`` is written: exactly the state dict the port's module
or encoder takes (``params=``, ``load_state_dict``), beside a
``<name>.config.json`` where the JAX tool writes one (CLIP, AudioCLIP,
NetVLAD).  ``--record-manifests`` re-pins the manifests from real files
instead of porting.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from avlmaps_torch.tools.ckpt_manifest import (MANIFEST_DIR, diff_state_dict,
                                               format_diff, load_manifest,
                                               record_manifest, save_manifest)

# checkpoint flag -> the manifest of its release artifact
MANIFEST_FOR = {
    "lseg": "lseg_demo_e200",
    "clip": "clip_vitb32",
    "audioclip": "audioclip_partial",
    "superpoint": "superpoint_v1",
    "superglue": "superglue_indoor",
    "netvlad": "netvlad_pitts30k",
    "wav2clip": "wav2clip_resnet18",
}


def _manifest_name(flag: str, path: str) -> Optional[str]:
    if flag == "superglue" and "outdoor" in Path(path).name.lower():
        return "superglue_outdoor"
    return MANIFEST_FOR.get(flag)


def _flatten_netvlad_mat(path: str) -> Dict[str, np.ndarray]:
    """The flat manifest-key view of a matconvnet NetVLAD file: weighted
    layers in order as ``layers.<i>_<name>.weights.<j>`` and the
    averageImage, the inverse of ``ckpt_manifest.assemble_netvlad_mat``'s
    keys (layers without weights are skipped, so the numbering does not
    depend on where the relu and pool layers sit)."""
    from scipy.io import loadmat

    from avlmaps_torch.models.netvlad.port import _as_list, weighted_layers

    net = loadmat(str(path), simplify_cells=True)["net"]
    out = {}
    for i, layer in enumerate(weighted_layers(net)):
        for j, w in enumerate(_as_list(layer["weights"])):
            out[f"layers.{i:02d}_{layer.get('name', '')}.weights.{j}"] = \
                np.asarray(w)
    meta = net.get("meta")
    if isinstance(meta, dict):
        norm = meta.get("normalization")
        if isinstance(norm, dict) and "averageImage" in norm:
            out["meta.normalization.averageImage"] = np.asarray(
                norm["averageImage"])
    return out


def _raw_state_dict(flag: str, path: str):
    """The checkpoint's state dict as its loader sees it: a CLIP jit
    archive's or a plain one (``state_dict`` unwrapped), or the flat view
    of a NetVLAD ``.mat``."""
    if flag == "netvlad":
        return _flatten_netvlad_mat(path)
    if flag == "clip":
        try:
            return torch.jit.load(str(path), map_location="cpu").state_dict()
        except RuntimeError:
            pass
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def check_against_manifest(flag: str, path: str, strict: bool) -> None:
    """The checkpoint's keys and shapes against its manifest, before
    porting; with ``strict``, drift raises ``SystemExit``."""
    name = _manifest_name(flag, path)
    if name is None or str(path).endswith(".msgpack"):
        return
    try:
        manifest = load_manifest(name)
    except FileNotFoundError:
        print(f"  [{flag}] no manifest {name}.json: contract check skipped")
        return
    diff = diff_state_dict(_raw_state_dict(flag, path), manifest)
    print(f"  [{flag}] manifest {name}: {format_diff(diff)}")
    if strict and any(diff.values()):
        raise SystemExit(
            f"{path} drifts from {name}.json; re-pin with "
            "--record-manifests once the file is verified, or port "
            "without --strict-manifest")


def record_manifests(args) -> None:
    """Re-pin the manifests from the real files given."""
    for flag in MANIFEST_FOR:
        path = getattr(args, flag)
        if not path:
            continue
        name = _manifest_name(flag, path)
        manifest = record_manifest(
            _raw_state_dict(flag, path), artifact=Path(path).name,
            source=str(path),
            container="matconvnet" if flag == "netvlad" else "state_dict")
        save_manifest(manifest, MANIFEST_DIR / f"{name}.json")
        print(f"re-pinned {name}.json from {path} "
              f"({len(manifest['keys'])} keys)")


class Ported(NamedTuple):
    """One artifact through the port's loader: the file stem, the state
    dict, the config sidecar (None where the JAX tool writes none) and
    the release-scale module it loads into, built on a device."""
    name: str
    params: Dict[str, torch.Tensor]
    config: Optional[Dict[str, Any]]
    module: Callable[[Any], torch.nn.Module]


def port_artifact(flag: str, path: str, lseg_layers: int = 24) -> Ported:
    """Run the port's loader for one checkpoint flag."""
    if flag == "lseg":
        from avlmaps_torch.models.lseg import LSegConfig, LSegNet
        from avlmaps_torch.models.lseg.port import load_lseg_checkpoint

        cfg = LSegConfig.vitl16()
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, layers=lseg_layers))
        return Ported("lseg", load_lseg_checkpoint(path, lseg_layers), None,
                      lambda dev: LSegNet(cfg, device=dev))
    if flag == "clip":
        from avlmaps_torch.models.clip.model import Clip
        from avlmaps_torch.models.clip.port import load_clip_checkpoint

        cfg, params = load_clip_checkpoint(path)
        print(f"  clip config: embed={cfg.embed_dim} "
              f"vision={cfg.vision_width}x{cfg.vision_layers} "
              f"text={cfg.text_width}x{cfg.text_layers}")
        return Ported("clip", params, dataclasses.asdict(cfg),
                      lambda dev: Clip(cfg, device=dev))
    if flag == "audioclip":
        from avlmaps_torch.models.audioclip.audioclip import AudioClip
        from avlmaps_torch.models.audioclip.port import (
            load_audioclip_checkpoint)

        cfg, params = load_audioclip_checkpoint(path)
        return Ported("audioclip", params, dataclasses.asdict(cfg),
                      lambda dev: AudioClip(cfg, device=dev))
    if flag == "superpoint":
        from avlmaps_torch.models.superpoint.model import SuperPointNet
        from avlmaps_torch.models.superpoint.port import (
            load_superpoint_checkpoint)

        cfg, params = load_superpoint_checkpoint(path)
        print(f"  superpoint config: channels={cfg.channels} "
              f"desc={cfg.desc_dim}")
        return Ported("superpoint", params, None,
                      lambda dev: SuperPointNet(cfg, device=dev))
    if flag == "superglue":
        from avlmaps_torch.models.superglue.model import SuperGlueNet
        from avlmaps_torch.models.superglue.port import (
            load_superglue_checkpoint)

        cfg, params = load_superglue_checkpoint(path)
        print(f"  superglue config: desc={cfg.desc_dim} "
              f"layers={cfg.gnn_layers}")
        outdoor = "outdoor" in Path(path).name.lower()
        return Ported("superglue_outdoor" if outdoor else "superglue",
                      params, None, lambda dev: SuperGlueNet(cfg, device=dev))
    if flag == "wav2clip":
        from avlmaps_torch.models.wav2clip import (Wav2Clip, Wav2ClipConfig,
                                                   port_wav2clip_state_dict)

        cfg = Wav2ClipConfig()
        return Ported("wav2clip", port_wav2clip_state_dict(
            _raw_state_dict(flag, path), cfg), None,
            lambda dev: Wav2Clip(cfg, device=dev))
    if flag == "netvlad":
        from avlmaps_torch.models.netvlad.model import NetVLAD
        from avlmaps_torch.models.netvlad.port import load_netvlad_mat

        params, avg, cfg = load_netvlad_mat(path)
        print(f"  netvlad config: clusters={cfg.clusters} dim={cfg.dim} "
              f"whiten={cfg.whiten_dim}")
        return Ported("netvlad", params, {
            "clusters": cfg.clusters, "dim": cfg.dim,
            "whiten_dim": cfg.whiten_dim,
            "average_image": [float(v) for v in avg]},
            lambda dev: NetVLAD(cfg, device=dev))
    raise ValueError(f"unknown checkpoint flag {flag!r}")


def strict_load(ported: Ported, device) -> torch.nn.Module:
    """``ported``'s release-scale module on ``device`` with its state
    dict loaded strictly (``"meta"``: shapes and names only)."""
    module = ported.module(device)
    module.load_state_dict(ported.params, strict=True,
                           assign=str(device) == "meta")
    return module


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    """Ports every checkpoint given; returns, by flag, the files written
    and the port's seconds (loader and strict load)."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--lseg", help="demo_e200.ckpt path")
    parser.add_argument("--clip", help="OpenAI CLIP .pt path")
    parser.add_argument("--audioclip",
                        help="AudioCLIP-Partial-Training.pt path")
    parser.add_argument("--superpoint", help="superpoint_v1.pth path")
    parser.add_argument("--superglue",
                        help="superglue_{indoor,outdoor}.pth path")
    parser.add_argument("--wav2clip",
                        help="wav2clip resnet18 state-dict path")
    parser.add_argument("--netvlad",
                        help="matconvnet Pitts30K NetVLAD .mat path")
    parser.add_argument("--lseg-layers", type=int, default=24,
                        help="ViT depth of the LSeg checkpoint")
    parser.add_argument("--out", default="ported")
    parser.add_argument("--strict-manifest", action="store_true",
                        help="fail (instead of warn) when a checkpoint "
                             "drifts from its tools/ckpt_manifests contract")
    parser.add_argument("--record-manifests", action="store_true",
                        help="re-pin tools/ckpt_manifests/*.json from the "
                             "given real files instead of porting")
    parser.add_argument("--device", default="cuda",
                        help="where the ported weights are strict-loaded "
                             "(default cuda; cpu for the plain path)")
    args = parser.parse_args(argv)
    flags = [f for f in MANIFEST_FOR if getattr(args, f)]
    if not flags:
        parser.error("provide at least one checkpoint path")
    if args.record_manifests:
        record_manifests(args)
        return {}
    from avlmaps_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    for flag in flags:
        check_against_manifest(flag, getattr(args, flag),
                               args.strict_manifest)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    done = {}
    for flag in flags:
        t0 = time.perf_counter()
        ported = port_artifact(flag, getattr(args, flag), args.lseg_layers)
        strict_load(ported, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        path = out / f"{ported.name}.pt"
        torch.save(ported.params, path)
        done[flag] = {"pt": path, "seconds": seconds}
        if ported.config is not None:
            cfg_path = out / f"{ported.name}.config.json"
            cfg_path.write_text(json.dumps(ported.config))
            done[flag]["config"] = cfg_path
        print(f"wrote {path} ({len(ported.params)} tensors; ported and "
              f"strict-loaded on {device} in {seconds:.2f} s)")
    return done


if __name__ == "__main__":
    main()
