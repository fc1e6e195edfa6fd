"""Show / save the raw and CLIP-customised obstacle maps
(reference application/generate_obstacle_map.py).

Usage:
  python -m avlmaps_torch.application.generate_obstacle_map \
      --data-dir /path/to/avlmaps_data [--scene-id 0] \
      [--config cfg.yaml] [--out-prefix obstacles] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from avlmaps_torch.application.create_map import scene_dirs
from avlmaps_torch.config import load_config
from avlmaps_torch.robot.lang_robot import LangRobot


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--scene-id", type=int, default=0)
    parser.add_argument("--config", default=None)
    parser.add_argument("--out-prefix", default="obstacles")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the CLIP scoring (default "
                             "cuda)")
    args = parser.parse_args(argv)

    import cv2

    config = load_config(args.config)
    data_dirs = scene_dirs(args.data_dir)

    robot = LangRobot(config, device=args.device)
    robot.load_scene_map(data_dirs[args.scene_id], config.map_config)
    obs = (robot.map.obstacles_cropped.astype(np.uint8)) * 255
    cv2.imwrite(f"{args.out_prefix}_raw.png", obs)

    robot.map.customize_obstacle_map(
        config.map_config.potential_obstacle_names,
        config.map_config.obstacle_names)
    custom = (robot.map.get_customized_obstacle_cropped()
              .astype(np.uint8)) * 255
    cv2.imwrite(f"{args.out_prefix}_customized.png", custom)
    print(f"wrote {args.out_prefix}_raw.png and "
          f"{args.out_prefix}_customized.png")


if __name__ == "__main__":
    main()
