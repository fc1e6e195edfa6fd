"""Interactive open-vocabulary map indexing REPL
(reference application/index_map.py).

Queries object / sound / area / image and visualises (or saves) the 3D
heatmap.  Works headless: pass --query/--type for one-shot mode.

Usage:
  python -m avlmaps_torch.application.index_map \
      --data-dir /path/to/avlmaps_data [--scene-id 0] [--config cfg.yaml] \
      [--type object --query chair] [--out heatmap.png] [--view topdown] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

from avlmaps_torch.application.create_map import scene_dirs
from avlmaps_torch.config import load_config
from avlmaps_torch.map.avlmap import AVLMap


def render_query_image(sim, pose_vec) -> np.ndarray:
    """Render the query image at a chosen pose in the simulator — the
    reference's image-query behaviour (application/index_map.py:100-111
    spins up habitat and grabs color_sensor at the clicked agent state).

    ``sim`` is any Simulator-protocol backend (HabitatSimulator live, or a
    fake in tests); ``pose_vec`` is (px, py, pz, qx, qy, qz, qw)."""
    from avlmaps_torch.geometry.transforms import pose_vec_to_tf

    sim.set_agent_tf(pose_vec_to_tf(np.asarray(pose_vec, np.float64)))
    obs = sim.get_observation()
    if not obs or "color_sensor" not in obs:
        raise RuntimeError("simulator returned no colour observation")
    return np.asarray(obs["color_sensor"])[..., :3]


def _query_image(query: str, sim=None) -> np.ndarray:
    """Resolve an image query: a file path (headless default), or
    ``pose:px,py,pz,qx,qy,qz,qw`` rendered live in the simulator when one
    is available (reference renders at an interactively chosen pose)."""
    if query.startswith("pose:"):
        if sim is None:
            raise RuntimeError(
                "pose: image queries need a simulator (habitat-sim not "
                "available / --scene-dir not set); pass an image path "
                "instead")
        vec = [float(v) for v in query[5:].split(",")]
        return render_query_image(sim, vec)
    from avlmaps_torch.pipeline.loader import load_rgb

    return load_rgb(query)


def run_query(avlmap: AVLMap, index_type: str, query: str,
              decay_rate: float, sim=None):
    if index_type == "object":
        return avlmap.index_object(query, decay_rate=decay_rate)
    if index_type == "sound":
        return avlmap.index_sound(query, decay_rate=decay_rate)
    if index_type == "area":
        return avlmap.index_area(query, decay_rate=decay_rate)
    if index_type == "image":
        return avlmap.index_image(_query_image(query, sim),
                                  decay_rate=decay_rate)
    raise ValueError(f"unknown index type {index_type!r}")


def save_heatmap(avlmap: AVLMap, heatmap: np.ndarray, out: Path,
                 view: str = "topdown", transparency: float = 0.5):
    """Write the heatmap as a top-down projection or a 3D point-cloud view
    (reference shows the 3D heatmap in an Open3D window,
    avlmaps/utils/visualize_utils.py:68-75; headless hosts get a rendered
    PNG / .ply instead)."""
    import cv2

    from avlmaps_torch.ops.pooling import pool_3d_value_to_2d_max

    if view == "3d":
        from avlmaps_torch.utils.visualize import visualize_heatmap_3d

        written = visualize_heatmap_3d(
            avlmap.vlmap.grid_pos.astype(np.float32), heatmap,
            avlmap.vlmap.grid_rgb, transparency=transparency,
            save_path=out)
        print(f"3D heatmap written to {written}")
        return

    gs = avlmap.vlmap.occupied_ids.shape[0]
    top = pool_3d_value_to_2d_max(heatmap, avlmap.vlmap.grid_pos, gs)
    img = cv2.applyColorMap((top * 255).astype(np.uint8), cv2.COLORMAP_JET)
    cv2.imwrite(str(out), img)
    print(f"heatmap written to {out}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--scene-id", type=int, default=0)
    parser.add_argument("--config", default=None)
    parser.add_argument("--type", choices=["object", "sound", "area",
                                           "image"], default=None,
                        help="one-shot query type (omit for the REPL)")
    parser.add_argument("--query", default=None,
                        help="query text (or image path for --type image)")
    parser.add_argument("--out", default="heatmap.png")
    parser.add_argument("--view", choices=["topdown", "3d"],
                        default="topdown",
                        help="3d renders the point-cloud heatmap (open3d "
                             "window / offscreen PNG / .ply)")
    parser.add_argument("--scene-dir", default="",
                        help="Matterport3D scene dir: enables live-rendered "
                             "pose:... image queries (needs habitat-sim)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the queries (default cuda)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    config.data_paths.avlmaps_data_dir = args.data_dir
    scene = scene_dirs(args.data_dir)[args.scene_id]

    avlmap = AVLMap(config, data_dir=str(scene), device=args.device)
    avlmap.load_map(scene)

    sim = None

    def get_sim():
        """Lazy habitat sim for live-rendered image queries (reference
        application/index_map.py:100-111); None when habitat is absent."""
        nonlocal sim
        from avlmaps_torch.robot.sim import (HABITAT_AVAILABLE,
                                             HabitatSimulator)

        if sim is None and args.scene_dir and HABITAT_AVAILABLE:
            scene_name = scene.name.split("_")[0]
            scene_path = (Path(args.scene_dir) / scene_name
                          / f"{scene_name}.glb")
            sim = HabitatSimulator(str(scene_path), {
                "sensor_height": config.data_cfg.camera_height,
                "width": config.data_cfg.resolution.w,
                "height": config.data_cfg.resolution.h,
                "color_sensor": True, "depth_sensor": False,
                "semantic_sensor": False, "back_color_sensor": False,
            })
        return sim

    if args.type:
        heat = run_query(avlmap, args.type, args.query, config.decay_rate,
                         sim=get_sim() if args.type == "image" else None)
        save_heatmap(avlmap, heat, Path(args.out), args.view)
        return

    menu = ("What do you want to index? (1. object, 2. sound, 3. area, "
            "4. image, 5. exit)\nInput: ")
    kinds = {"1": "object", "2": "sound", "3": "area", "4": "image"}
    while True:
        choice = input(menu).strip()
        if choice not in kinds:
            break
        query = input("Query: ").strip()
        heat = run_query(avlmap, kinds[choice], query, config.decay_rate,
                         sim=get_sim() if kinds[choice] == "image" else None)
        save_heatmap(avlmap, heat, Path(args.out), args.view)


if __name__ == "__main__":
    main()
