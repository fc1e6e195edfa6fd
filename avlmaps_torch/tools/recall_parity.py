"""Recall-parity harness for the port.

Counterpart of ``tools/recall_parity.py``.  Builds the same scene's VLMap
twice -- (a) with the reference's torch network
(:mod:`avlmaps_torch.tools.reference_lseg`) and an independent host-loop
sequential fusion (the reference's algorithm,
avlmaps/map/vlmap_builder.py:102-183), and (b) through the port's
``VLMapBuilder`` with its ``LSegNet`` on the same weights -- then scores
both maps against the same text features and reports landmark top-1
indexing agreement, what the reference's users consume
(avlmaps/map/vlmap.py index_map + avlmaps/utils/clip_utils.py:96-159).
The port's map is scored by ``ops.similarity.score_argmax`` (K7 on a
card), the oracle's by numpy.

Runs on synthetic weights out of the box, on the card unless told
otherwise:

    python -m avlmaps_torch.tools.recall_parity --tiny [--device cpu]
    python -m avlmaps_torch.tools.recall_parity --medium [--device cpu]

With real checkpoints (demo_e200.ckpt; the weights load into both
networks):

    python -m avlmaps_torch.tools.recall_parity --scene DIR \\
        --lseg-ckpt demo_e200.ckpt [--clip-ckpt ViT-B-32.pt \\
        --landmarks "chair,table,sofa"]

Both networks run in f32 with TF32 off.  The report's keys are the JAX
tool's (``voxels_flax`` counts the build under test).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.map.vlmap_builder import sample_pixels
from avlmaps_torch.models.lseg.window import normalize_image, plan_windows
from avlmaps_torch.pipeline.loader import load_depth, load_rgb
from avlmaps_torch.utils.device import full_f32, resolve_device


# ---------------------------------------------------------------------------
# synthetic scene: coloured bands at distinct depths, so landmarks differ
# spatially
# ---------------------------------------------------------------------------


def write_synthetic_scene(root: Path, n_frames: int = 6, h: int = 32,
                          w: int = 32, seed: int = 0) -> Path:
    import cv2

    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    poses = []
    for i in range(n_frames):
        # vertical colour bands: distinct "objects" at distinct depths
        rgb = np.zeros((h, w, 3), np.uint8)
        for b, color in enumerate([(220, 40, 40), (40, 220, 40),
                                   (40, 40, 220), (220, 220, 40)]):
            rgb[:, b * w // 4:(b + 1) * w // 4] = color
        rgb = np.clip(rgb.astype(np.int32)
                      + rng.integers(-20, 20, rgb.shape), 0, 255
                      ).astype(np.uint8)
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"), rgb[:, :, ::-1])
        depth = np.zeros((h, w), np.float32)
        for b in range(4):
            depth[:, b * w // 4:(b + 1) * w // 4] = 0.4 + 0.25 * b
        depth += rng.uniform(-0.02, 0.02, depth.shape).astype(np.float32)
        np.save(root / "depth" / f"{i:06d}.npy", depth)
        poses.append([0.03 * i, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(root / "poses.txt", np.asarray(poses))
    return root


def scene_frames(scene: Path):
    return (sorted((scene / "rgb").glob("*.png")),
            sorted((scene / "depth").glob("*.npy")))


# ---------------------------------------------------------------------------
# oracle map build: the reference network + numpy sequential fusion
# ---------------------------------------------------------------------------


def oracle_build_map(torch_model, scene: Path, cfg, base2cam, base_tf,
                     out_dim: int, batch_size: int, seed: int):
    """Host-loop map build with the reference algorithm and network
    (``torch_model``, on any device; run in f32 with TF32 off).  Consumes
    the same pixel-sample stream as ``VLMapBuilder`` (same seed, same
    batching), so the two maps differ only by the networks and fusions
    under test.  Returns (pos (N, 3) int32, feat (N, out_dim) f32), the
    voxels in sorted order."""
    gs, cs, vh = cfg.gs, cfg.cs, cfg.vh
    rgb_paths, depth_paths = scene_frames(scene)
    base_poses = np.loadtxt(scene / "poses.txt")
    if base_poses.ndim == 1:
        base_poses = base_poses[None]
    dev = next(torch_model.parameters()).device

    inv_bt = np.linalg.inv(base_tf)
    init_base_tf = base_tf @ pose_vec_to_tf(base_poses[0]) @ inv_bt
    inv_init = np.linalg.inv(init_base_tf)
    pose_tfs = [inv_init @ (base_tf @ pose_vec_to_tf(v) @ inv_bt)
                @ base_tf @ base2cam for v in base_poses]

    probe = np.asarray(load_depth(depth_paths[0]), np.float32)
    h, w = probe.shape[:2]
    max_pts = cfg.point_budget(h, w)
    base_size = getattr(cfg, "lseg_base_size", 520)
    crop_size = getattr(cfg, "lseg_crop_size", 480)
    height, width, _, _, crops = plan_windows(h, w, base_size, crop_size)
    if (height, width) != (h, w) or len(crops) != 1:
        raise ValueError("oracle supports single-window full-image eval "
                         "only; set lseg_base_size = lseg_crop_size = image "
                         "size")
    calib = cfg.calib_matrix()
    inv_calib = np.linalg.inv(calib).astype(np.float32)
    feat_intr = get_sim_cam_mat(height, width).astype(np.float32)

    rng = np.random.default_rng(seed)
    # sequential per-voxel running weighted mean (associative form), f64
    feats_acc: dict = {}

    n = len(rgb_paths)
    for start in range(0, n, batch_size):
        idx = sample_pixels(rng, h, w, cfg.depth_sample_rate, max_pts,
                            batch_size)
        for bi in range(batch_size):
            fi = start + bi
            if fi >= n:
                continue
            rgb = np.asarray(load_rgb(rgb_paths[fi]))
            depth = np.asarray(load_depth(depth_paths[fi]), np.float32)
            rgb_norm = normalize_image(rgb).astype(np.float32)
            x = torch.from_numpy(rgb_norm.transpose(2, 0, 1)[None]).to(dev)
            with torch.no_grad(), full_f32():
                canvas = torch_model(x)[0]
            canvas = canvas.cpu().numpy().transpose(1, 2, 0)  # (H, W, D)
            if canvas.shape[:2] != (height, width):
                raise ValueError(f"oracle canvas {canvas.shape[:2]} != "
                                 f"({height}, {width})")

            sample = idx[bi]
            px = (sample % w).astype(np.float32)
            py = (sample // w).astype(np.float32)
            z = depth.reshape(-1)[sample]
            uv1 = np.stack([px + 0.5, py + 0.5, np.ones_like(px)], axis=-1)
            rays = uv1 @ inv_calib.T
            pc_local = rays * z[:, None]
            zmask = (z > cfg.min_depth) & (z < cfg.max_depth)
            pose = pose_tfs[fi].astype(np.float32)
            pc_global = pc_local @ pose[:3, :3].T + pose[:3, 3]

            row = np.trunc(gs / 2 - np.trunc(pc_global[:, 0] / cs)
                           ).astype(np.int64)
            col = np.trunc(gs / 2 - np.trunc(pc_global[:, 1] / cs)
                           ).astype(np.int64)
            hh = np.trunc(pc_global[:, 2] / cs).astype(np.int64)
            in_grid = ((row >= 0) & (row < gs) & (col >= 0) & (col < gs)
                       & (hh >= 0) & (hh < vh))

            uvw = pc_local @ feat_intr.T
            fx = np.trunc(uvw[:, 0] / uvw[:, 2] - 0.5).astype(np.int64)
            fy = np.trunc(uvw[:, 1] / uvw[:, 2] - 0.5).astype(np.int64)
            in_feat = (fx >= 0) & (fx < width) & (fy >= 0) & (fy < height)
            alpha = np.exp(-np.sum(pc_local ** 2, axis=1) / (2 * 0.6))
            ok = zmask & in_grid & in_feat
            for j in np.nonzero(ok)[0]:
                key = (int(row[j]), int(col[j]), int(hh[j]))
                f = canvas[fy[j], fx[j]]
                a = float(alpha[j])
                if key in feats_acc:
                    sf, sw = feats_acc[key]
                    feats_acc[key] = (sf + a * f, sw + a)
                else:
                    feats_acc[key] = (a * f.astype(np.float64), a)

    keys = sorted(feats_acc)
    pos = np.asarray(keys, np.int32).reshape(-1, 3)
    feat = np.stack([feats_acc[k][0] / feats_acc[k][1] for k in keys]
                    ).astype(np.float32).reshape(-1, out_dim)
    return pos, feat


# ---------------------------------------------------------------------------
# the port's build, the scoring and the comparison
# ---------------------------------------------------------------------------


def port_build_map(net, scene: Path, cfg, base2cam, base_tf, out_dim: int,
                   batch_size: int, seed: int, device, save_dir=None):
    """The port's map of ``scene`` through its entry point,
    ``VLMapBuilder.create_mobile_base_map``, with ``net`` (an ``LSegNet``)
    at full output resolution.  An f32 ``net`` runs with TF32 off; a bf16
    one runs the ViT kernels on a card.  The map is saved in ``save_dir``
    (default the builder's ``<scene>/vlmap``, where a saved map is
    resumed, as in the JAX tool).  Returns the SparseVoxelMap."""
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    rgb_paths, depth_paths = scene_frames(scene)
    builder = VLMapBuilder(
        scene, cfg, scene / "poses.txt", rgb_paths, depth_paths, base2cam,
        base_tf, lseg_apply=net, feat_dim=out_dim, batch_size=batch_size,
        seed=seed, device=device, map_save_dir=save_dir)
    f32 = net.cfg.dtype == torch.float32
    with torch.no_grad(), (full_f32() if f32 else contextlib.nullcontext()):
        return builder.create_mobile_base_map(save_every=0, progress=False)


def landmark_text_features(landmarks: Sequence[str], out_dim: int,
                           clip_ckpt=None, device="cpu") -> np.ndarray:
    """Text features for scoring.  With a CLIP checkpoint: the real
    prompt-ensembled embeddings (both maps see the same matrix either way,
    so parity is measured identically); else seeded unit vectors."""
    if clip_ckpt:
        from avlmaps_torch.models.clip import ClipEncoder

        enc = ClipEncoder.from_checkpoint(str(clip_ckpt), device=device)
        return np.asarray(
            enc.get_text_feats_multiple_templates(list(landmarks)),
            np.float32)
    rng = np.random.default_rng(42)
    t = rng.normal(size=(len(landmarks), out_dim)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def _unit(feat: np.ndarray) -> np.ndarray:
    return feat / np.maximum(np.linalg.norm(feat, axis=1, keepdims=True),
                             1e-8)


def score_top1(feat: np.ndarray, text: np.ndarray) -> np.ndarray:
    """The oracle's scoring: numpy cosine scores, first-index argmax."""
    return np.argmax(_unit(feat) @ text.T, axis=1)


def port_top1(feat: np.ndarray, text: np.ndarray, device) -> np.ndarray:
    """The port's scoring of its map: ``score_argmax`` (K7 on a card, its
    plain version on the CPU)."""
    from avlmaps_torch.ops.similarity import score_argmax

    dev = resolve_device(device)
    labels = score_argmax(torch.from_numpy(feat).to(dev),
                          torch.from_numpy(text).to(dev),
                          normalize_map=True)
    return labels.cpu().numpy().astype(np.int64)


def common_voxels(pos_a: np.ndarray, pos_b: np.ndarray):
    """Rows of ``pos_a`` and ``pos_b`` holding the same voxel, in sorted
    voxel order, and the size of the union of both sets."""
    ka = {tuple(p): i for i, p in enumerate(pos_a.tolist())}
    kb = {tuple(p): i for i, p in enumerate(pos_b.tolist())}
    common = sorted(set(ka) & set(kb))
    ia = np.asarray([ka[k] for k in common], np.int64)
    ib = np.asarray([kb[k] for k in common], np.int64)
    return ia, ib, len(set(ka) | set(kb))


def compare_maps(pos: np.ndarray, feat: np.ndarray, top1: np.ndarray,
                 opos: np.ndarray, ofeat: np.ndarray, otop1: np.ndarray,
                 landmarks: Sequence[str], mode: str) -> Dict:
    """The JAX tool's report: voxel counts and IoU, top-1 agreement and
    feature cosines over the common voxels, per-landmark IoU of the
    top-1 sets."""
    ia, ib, n_union = common_voxels(pos, opos)
    agree = int((top1[ia] == otop1[ib]).sum())
    cos = np.einsum("ij,ij->i", _unit(feat[ia]),
                    _unit(ofeat[ib])).astype(np.float64)
    per_landmark = {}
    for ci, name in enumerate(landmarks):
        fv, ov = top1[ia] == ci, otop1[ib] == ci
        denom = int((fv | ov).sum())
        per_landmark[name] = (int((fv & ov).sum()) / denom) if denom else 1.0
    return {
        "mode": mode,
        "voxels_flax": int(pos.shape[0]),
        "voxels_oracle": int(opos.shape[0]),
        "voxel_iou": len(ia) / max(n_union, 1),
        "top1_agreement": agree / max(len(ia), 1),
        "feature_cos_mean": float(np.mean(cos)) if len(ia) else 0.0,
        "feature_cos_min": float(np.min(cos)) if len(ia) else 0.0,
        "per_landmark_iou": per_landmark,
    }


def near_ties(pos: np.ndarray, feat: np.ndarray, top1: np.ndarray,
              opos: np.ndarray, ofeat: np.ndarray, otop1: np.ndarray,
              text: np.ndarray, tol: float) -> Dict:
    """The top-1 disagreements over the common voxels, split by whether
    each is a near tie: the oracle's top-1 minus top-2 score is below
    ``tol``.  ``tol`` comes from outside the map under test (a map that
    is further off must not widen its own allowance); the largest
    |score difference| between the two maps is reported beside it."""
    ia, ib, _ = common_voxels(pos, opos)
    s = _unit(feat[ia].astype(np.float64)) @ text.T.astype(np.float64)
    so = _unit(ofeat[ib].astype(np.float64)) @ text.T.astype(np.float64)
    max_d = float(np.abs(s - so).max()) if len(ia) else 0.0
    top2 = np.sort(so, axis=1)[:, -2:]
    margin = top2[:, -1] - top2[:, 0]
    off = top1[ia] != otop1[ib]
    return {"disagreements": int(off.sum()),
            "near_ties": int((off & (margin < tol)).sum()),
            "not_near_ties": int((off & (margin >= tol)).sum()),
            "tie_tol": float(tol), "max_score_d": max_d}


def passed(report: Dict, medium: bool) -> bool:
    """The JAX tool's gate.  Voxel membership does not depend on the
    network (pose/depth/trunc math only); the residual IoU gap is
    single-ulp trunc flips where a point lands exactly on a cell boundary
    (device against host f32 in the pose product).  Top-1 agreement on
    the common voxels is the recall contract."""
    iou_min = 0.97 if medium else 0.99
    return report["voxel_iou"] > iou_min and report["top1_agreement"] > 0.99


def build_oracle(mode: str, seed: int, lseg_ckpt=None):
    """The oracle network on the CPU: ``mode`` is ``"tiny"``,
    ``"medium"`` or ``"vitl16"`` (seeded, or ``lseg_ckpt``'s weights).
    Returns (oracle, spec)."""
    from avlmaps_torch.tools.reference_lseg import (
        TorchLSegSpec, build_torch_lseg, load_reference_state_dict)

    spec = {"tiny": TorchLSegSpec.tiny16, "medium": TorchLSegSpec.medium,
            "vitl16": TorchLSegSpec}[mode]()
    oracle = build_torch_lseg(spec, seed=seed)
    if lseg_ckpt:
        ckpt = torch.load(lseg_ckpt, map_location="cpu", weights_only=False)
        load_reference_state_dict(oracle, ckpt.get("state_dict", ckpt))
    return oracle, spec


def port_network(oracle, spec, mode: str, device,
                 dtype: torch.dtype = torch.float32):
    """The port's ``LSegNet`` on ``device`` with the oracle's weights,
    ported through ``port_lseg_state_dict``; a bf16 net has its matrices
    cast once (the kernels' operands on a card)."""
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           params_from_flax)
    from avlmaps_torch.models.lseg.port import port_lseg_state_dict
    from avlmaps_torch.tools.reference_lseg import export_reference_state_dict

    sd = export_reference_state_dict(oracle)
    cfg = getattr(LSegConfig, "tiny16" if mode == "tiny" else mode)(dtype)
    net = LSegNet(cfg, device=resolve_device(device))
    net.load_state_dict(params_from_flax(
        port_lseg_state_dict(sd, vit_layers=spec.layers)), strict=True)
    if dtype != torch.float32:
        cast_params_for_inference(net, dtype)
    return net.eval().requires_grad_(False)


def map_config(mode: str, h: int, w: int):
    """The JAX tool's map settings for ``mode`` at (h, w) frames, the
    whole frame as one LSeg window; returns (map config, base2cam,
    base transform)."""
    from avlmaps_torch.config import load_config
    from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                                   build_base_transform)

    mc = load_config().map_config
    if mode == "tiny":
        mc.grid_size = 64
        mc.cell_size = 0.1
        mc.pose_info.camera_height = 0.8
        mc.capacity = 16384
        mc.depth_sample_rate = 4
        mc.max_pts_per_frame = 256
        mc.max_depth = 6.0
    elif mode == "medium":
        mc.grid_size = 128
        mc.cell_size = 0.05
        mc.pose_info.camera_height = 0.8
        mc.capacity = 32768
        mc.depth_sample_rate = 36  # 192^2/36 = 1024 points per frame
        mc.max_pts_per_frame = 1024
        mc.max_depth = 6.0
    mc.cam_calib_mat = tuple(get_sim_cam_mat(h, w).reshape(-1))
    mc.lseg_base_size = max(h, w)
    mc.lseg_crop_size = max(h, w)
    pi = mc.pose_info
    base2cam = build_base2cam_tf(pi.base2cam_rot, pi.camera_height)
    base_tf = build_base_transform(pi.base_forward_axis, pi.base_left_axis,
                                   pi.base_up_axis)
    return mc, base2cam, base_tf


def score_and_compare(pos, feat, opos, ofeat, text: np.ndarray,
                      landmarks: Sequence[str], mode: str, device):
    """Both maps scored (the port's by ``score_argmax``, the oracle's by
    numpy) and compared; returns (report, port top-1, oracle top-1)."""
    top1 = port_top1(feat, text, device)
    otop1 = score_top1(ofeat, text)
    return (compare_maps(pos, feat, top1, opos, ofeat, otop1, landmarks,
                         mode), top1, otop1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", type=Path, default=None,
                    help="scene dir (rgb/ depth/ poses.txt); synthetic if "
                         "omitted")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny synthetic-weight mode (default when no "
                         "checkpoint is given)")
    ap.add_argument("--medium", action="store_true",
                    help="medium-scale synthetic-weight mode: 12-layer "
                         "width-256 towers with the real hook spacing, "
                         "192x192 frames")
    ap.add_argument("--lseg-ckpt", type=Path, default=None)
    ap.add_argument("--clip-ckpt", type=Path, default=None)
    ap.add_argument("--landmarks", type=str,
                    default="chair,table,sofa,bed,plant")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON report here too")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card; cpu for the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mode = ("tiny" if args.lseg_ckpt is None and not args.medium
            else "medium" if args.medium else "vitl16")
    landmarks = [s.strip() for s in args.landmarks.split(",") if s.strip()]
    # as in the JAX tool, --medium takes seeded weights even with a
    # checkpoint given
    oracle, spec = build_oracle(
        mode, args.seed, args.lseg_ckpt if mode == "vitl16" else None)
    net = port_network(oracle, spec, mode, device)
    oracle.to(device)

    with tempfile.TemporaryDirectory() as tmp:
        scene = args.scene
        if scene is None:
            hw = 192 if mode == "medium" else 32
            scene = write_synthetic_scene(
                Path(tmp) / "scene", n_frames=4 if mode == "medium" else 6,
                h=hw, w=hw)
        scene = Path(scene)
        h, w = np.load(scene_frames(scene)[1][0]).shape[:2]
        mc, base2cam, base_tf = map_config(mode, h, w)
        m = port_build_map(net, scene, mc, base2cam, base_tf, spec.out_dim,
                           args.batch_size, args.seed, device)
        print(f"[port]   {m.grid_pos.shape[0]} voxels")
        opos, ofeat = oracle_build_map(oracle, scene, mc, base2cam, base_tf,
                                       spec.out_dim, args.batch_size,
                                       args.seed)
        print(f"[oracle] {opos.shape[0]} voxels")
    text = landmark_text_features(landmarks, spec.out_dim,
                                  clip_ckpt=args.clip_ckpt, device=device)
    if text.shape[1] != spec.out_dim:
        raise ValueError(f"text dim {text.shape[1]} != map dim "
                         f"{spec.out_dim}")
    report = score_and_compare(
        m.grid_pos, m.grid_feat, opos, ofeat, text, landmarks,
        {"tiny": "tiny-synthetic", "medium": "medium-synthetic",
         "vitl16": "real-checkpoint"}[mode], device)[0]
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    ok = passed(report, mode == "medium")
    print("RECALL PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
