"""Pack a scene's rgb/ + depth/ frames into one .avpack for fast builds.

Counterpart of ``tools/pack_scene.py``: the same file, byte for byte.
The reference decodes every PNG/npy on every build
(avlmaps/map/vlmap_builder.py:118-120); packing decodes once, and map
builds then stream raw bytes (``avlmaps_torch/pipeline/packed.py``).
``VLMapBuilder`` reads ``<scene>/scene.avpack`` when it matches.  Host
only:

    python -m avlmaps_torch.tools.pack_scene DATA_DIR [--out PATH]
        [--no-canvas] [--base-size 520] [--crop-size 480] [--depth-f32]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from avlmaps_torch.models.lseg.window import plan_windows
from avlmaps_torch.pipeline.loader import load_depth
from avlmaps_torch.pipeline.packed import pack_scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", help="scene dir containing rgb/ and depth/")
    ap.add_argument("--out", default=None,
                    help="output path (default <data_dir>/scene.avpack)")
    ap.add_argument("--no-canvas", action="store_true",
                    help="skip the precomputed LSeg canvas section")
    ap.add_argument("--base-size", type=int, default=520,
                    help="LSeg base size for the canvas geometry")
    ap.add_argument("--crop-size", type=int, default=480)
    ap.add_argument("--depth-f32", action="store_true",
                    help="store float32 metres instead of uint16 mm")
    args = ap.parse_args(argv)

    root = Path(args.data_dir)
    rgb_paths = sorted((root / "rgb").glob("*.png"))
    depth_paths = sorted((root / "depth").glob("*.npy"))
    if not rgb_paths or len(rgb_paths) != len(depth_paths):
        print(f"error: {len(rgb_paths)} rgb vs {len(depth_paths)} depth "
              f"frames under {root}", file=sys.stderr)
        return 1

    canvas_hw = None
    if not args.no_canvas:
        probe = np.asarray(load_depth(depth_paths[0]))
        if probe.ndim == 3:
            probe = probe[..., 0]
        h, w = probe.shape
        ch, cw, _, _, _ = plan_windows(h, w, args.base_size, args.crop_size)
        canvas_hw = (ch, cw)

    out = Path(args.out) if args.out else root / "scene.avpack"
    pack_scene(rgb_paths, depth_paths, out, canvas_hw=canvas_hw,
               depth_dtype="f32" if args.depth_f32 else "u16mm",
               progress=True)
    size_mb = out.stat().st_size / 2**20
    print(f"packed {len(rgb_paths)} frames -> {out} ({size_mb:.0f} MB, "
          f"canvas={canvas_hw})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
