"""Visual-localisation accuracy eval: SuperPoint + mutual-NN against the
ORB fallback, and SuperGlue given its checkpoint.

Counterpart of ``tools/loc_eval.py``.  Renders a synthetic textured
trajectory (known camera translations as image-plane shifts at constant
depth), perturbs the queries (brightness, noise) and reports each
method's median / mean / max translation error through the port's
``VisualMap.refine_pose`` (reference: SuperPoint + SuperGlue,
avlmaps/utils/localization_utils.py:127-145, 247-273).

    python -m avlmaps_torch.tools.loc_eval [--device cpu] \\
        [--superpoint-ckpt superpoint_v1.pth] \\
        [--superglue-ckpt superglue_indoor.pth]

Without a checkpoint the SuperPoint row runs seeded random conv weights
(still locally distinctive descriptors; the real weights strictly
improve it).  The networks run on ``--device`` (default cuda; raises
without a card).
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from avlmaps_torch.geometry.projection import get_sim_cam_mat

H, W = 240, 320
DEPTH = 2.0
TRANSLATIONS = [0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4]
# the SuperPoint of the seeded row: narrow, every keypoint kept
SEEDED_SUPERPOINT = dict(channels=(8, 8, 16, 16), det_ch=32, desc_ch=32,
                         desc_dim=32, max_keypoints=1024,
                         score_threshold=0.0)


def textured_canvas(rng, h, w):
    import cv2

    canvas = np.full((h, w, 3), 30, np.uint8)
    for _ in range(500):
        x, y = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 8))
        sz = int(rng.integers(3, 9))
        color = tuple(int(c) for c in rng.integers(40, 255, 3))
        cv2.rectangle(canvas, (x, y), (x + sz, y + sz), color, -1)
    return canvas


def perturb(img, rng, brightness=20, noise=6):
    out = img.astype(np.int32) + int(rng.integers(-brightness, brightness))
    out = out + rng.integers(-noise, noise, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def build_scene(root: Path, translations, rng):
    """One mapped frame (texture, constant depth, identity pose) under
    ``root`` and the perturbed queries: (true x translation, image)."""
    import cv2

    fx = get_sim_cam_mat(H, W)[0, 0]
    max_shift = int(round(fx * max(translations) / DEPTH)) + 1
    tex = textured_canvas(rng, H, W + max_shift)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    cv2.imwrite(str(root / "rgb" / "000000.png"), tex[:, :W][:, :, ::-1])
    np.save(root / "depth" / "000000.npy",
            np.full((H, W), DEPTH, np.float32))
    np.savetxt(root / "poses.txt", np.asarray([[0, 0, 0, 0, 0, 0, 1.0]]))
    queries = []
    for tx in translations:
        shift = int(round(fx * tx / DEPTH))
        queries.append((shift * DEPTH / fx, perturb(tex[:, shift:W + shift],
                                                    rng)))
    return queries


def evaluate(vmap, queries, intr):
    errs, fails = [], 0
    for tx_true, q in queries:
        cam_tf = vmap.refine_pose(q, 0, intr)
        if cam_tf is None:
            fails += 1
            continue
        delta = cam_tf[:3, 3] - vmap._ref_cam_tf(0)[:3, 3]
        errs.append(float(np.linalg.norm(delta - np.array([tx_true, 0, 0]))))
    return {
        "n": len(queries),
        "failures": fails,
        "median_err_m": float(np.median(errs)) if errs else None,
        "mean_err_m": float(np.mean(errs)) if errs else None,
        "max_err_m": float(np.max(errs)) if errs else None,
    }


def evaluate_methods(superpoint, superglue=None, seed: int = 0,
                     device="cuda",
                     superpoint_mode: str = "seeded random weights") -> dict:
    """The report: ORB, ``superpoint`` with the mutual-NN matcher and,
    given ``superglue``, ``superpoint`` with it, each on the same scene
    and queries (drawn from ``seed``)."""
    from avlmaps_torch.config import load_config
    from avlmaps_torch.geometry.transforms import pose_vec_to_tf
    from avlmaps_torch.map.visual_map import VisualMap

    rng = np.random.default_rng(seed)
    intr = get_sim_cam_mat(H, W)
    cfg = load_config()
    cfg.map_config.cam_calib_mat = tuple(intr.reshape(-1))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "scene"
        queries = build_scene(root, TRANSLATIONS, rng)

        def make_vmap(superpoint=None, superglue=None):
            m = VisualMap(cfg.map_config, str(root), superpoint=superpoint,
                          superglue=superglue, device=device)
            m.data_dir = root
            m.poses = np.stack([pose_vec_to_tf([0, 0, 0, 0, 0, 0, 1.0])])
            m.descriptors = np.ones((1, 8), np.float32)
            return m

        report = {
            "superpoint_mode": superpoint_mode,
            "orb": evaluate(make_vmap(None), queries, intr),
            "superpoint_mnn": evaluate(make_vmap(superpoint), queries, intr),
        }
        if superglue is not None:
            report["superpoint_superglue"] = evaluate(
                make_vmap(superpoint, superglue=superglue), queries, intr)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--superpoint-ckpt", type=Path, default=None)
    ap.add_argument("--superglue-ckpt", type=Path, default=None,
                    help="superglue_{indoor,outdoor}.pth; adds a "
                    "superpoint_superglue row to the report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card; cpu for the plain path)")
    args = ap.parse_args(argv)

    from avlmaps_torch.models.superpoint import (
        SuperPointConfig, SuperPointExtractor, load_superpoint_checkpoint)

    if args.superpoint_ckpt:
        sp_cfg, sp_params = load_superpoint_checkpoint(
            str(args.superpoint_ckpt))
        sp = SuperPointExtractor(sp_cfg, params=sp_params,
                                 device=args.device)
        sp_mode = "superpoint_v1 weights"
    else:
        sp = SuperPointExtractor(SuperPointConfig(**SEEDED_SUPERPOINT),
                                 device=args.device)
        sp_mode = "random weights (pass --superpoint-ckpt for the real ones)"
    sg = None
    if args.superglue_ckpt:
        from avlmaps_torch.models.superglue import (
            SuperGlueMatcher, load_superglue_checkpoint)

        sg_cfg, sg_params = load_superglue_checkpoint(
            str(args.superglue_ckpt))
        sg = SuperGlueMatcher(sg_cfg, params=sg_params, device=args.device)
    report = evaluate_methods(sp, sg, seed=args.seed, device=args.device,
                              superpoint_mode=sp_mode)
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
