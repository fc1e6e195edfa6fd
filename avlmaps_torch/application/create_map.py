"""Build the AVLMap for one scene (reference application/create_map.py).

Usage:
  python -m avlmaps_torch.application.create_map \
      --data-dir /path/to/avlmaps_data [--scene-id 0] \
      [--config path/to/cfg.yaml] [--pack-first] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from avlmaps_torch.config import load_config
from avlmaps_torch.map.avlmap import AVLMap


def scene_dirs(data_dir) -> List[Path]:
    """The scene directories under ``<data_dir>/avlmaps_dataset`` (or
    ``vlmaps_dataset``), sorted."""
    dataset = Path(data_dir) / "avlmaps_dataset"
    if not dataset.exists():
        dataset = Path(data_dir) / "vlmaps_dataset"
    return sorted([x for x in dataset.iterdir() if x.is_dir()])


def pack_first(scene_dir: Path, base_size: int = 520,
               crop_size: int = 480) -> Path:
    """``<scene_dir>/scene.avpack`` with the LSeg canvas and uint16-mm
    depth (the defaults of the repository's pack tool)."""
    import numpy as np

    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.pipeline.loader import load_depth
    from avlmaps_torch.pipeline.packed import pack_scene

    rgb_paths = sorted((scene_dir / "rgb").glob("*.png"))
    depth_paths = sorted((scene_dir / "depth").glob("*.npy"))
    probe = np.asarray(load_depth(depth_paths[0]))
    if probe.ndim == 3:
        probe = probe[..., 0]
    ch, cw, _, _, _ = plan_windows(*probe.shape, base_size, crop_size)
    return pack_scene(rgb_paths, depth_paths, scene_dir / "scene.avpack",
                      canvas_hw=(ch, cw))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True,
                        help="root dir containing avlmaps_dataset/")
    parser.add_argument("--scene-id", type=int, default=0)
    parser.add_argument("--config", default=None, help="optional YAML config")
    parser.add_argument("--pack-first", action="store_true",
                        help="pack the scene to scene.avpack before building "
                             "(decode-once ingestion, pipeline/packed.py); "
                             "subsequent builds auto-detect the pack")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the build (default cuda)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    config.data_paths.avlmaps_data_dir = args.data_dir
    config.scene_id = args.scene_id

    scene_dir = scene_dirs(args.data_dir)[config.scene_id]
    if args.pack_first and not (scene_dir / "scene.avpack").exists():
        pack_first(scene_dir)

    avlmap = AVLMap(config, data_dir=str(scene_dir), device=args.device)
    avlmap.create_map(scene_dir)
    print(f"map created for {scene_dir}")


if __name__ == "__main__":
    main()
