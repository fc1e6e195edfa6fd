"""3D map visualisation (reference avlmaps/utils/visualize_utils.py:10-75).

Counterpart of ``avlmaps_tpu/utils/visualize.py`` (host numpy; open3d,
matplotlib and OpenCV imported where used).

The reference opens Open3D windows (visualize_rgb_map_3d /
visualize_heatmap_3d) or writes .pcd files.  Same API here, with graceful
degradation for headless hosts without open3d: an offscreen matplotlib 3D
scatter rendered to PNG, or an ASCII .ply dump (loadable by any point-cloud
viewer) when matplotlib is unavailable too.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np


def convert_heatmap_to_rgb(heatmap: np.ndarray, rgb: np.ndarray,
                           transparency: float = 0.5) -> np.ndarray:
    """JET-colormap blend of a [0,1] heatmap with the voxel colours
    (reference convert_heatmap_to_rgb, visualize_utils.py:60-66)."""
    import cv2

    sim = (np.asarray(heatmap) * 255).astype(np.uint8)
    heat = cv2.applyColorMap(sim, cv2.COLORMAP_JET)
    heat = heat.reshape(-1, 3)[:, ::-1].astype(np.float32)
    return heat * transparency + np.asarray(rgb, np.float32) \
        * (1 - transparency)


def write_ply(path: Union[str, Path], pc: np.ndarray,
              rgb: np.ndarray) -> None:
    """Minimal ASCII .ply point-cloud writer (no deps)."""
    pc = np.asarray(pc, np.float32)
    rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {pc.shape[0]}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(pc, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def _matplotlib_scatter(pc: np.ndarray, rgb: np.ndarray,
                        save_path: Union[str, Path],
                        max_points: int = 60000, elev: float = 35.0,
                        azim: float = -60.0) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if pc.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pc.shape[0], max_points,
                                              replace=False)
        pc, rgb = pc[sel], rgb[sel]
    fig = plt.figure(figsize=(10, 10), dpi=110)
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2],
               c=np.clip(rgb, 0, 255) / 255.0, s=1.2, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect(np.ptp(pc, axis=0) + 1e-6)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(save_path)
    plt.close(fig)


def visualize_rgb_map_3d(pc: np.ndarray, rgb: np.ndarray,
                         save_path: Optional[Union[str, Path]] = None
                         ) -> Optional[Path]:
    """Show (open3d window) or save a coloured point cloud
    (reference visualize_rgb_map_3d, visualize_utils.py:10-26).

    Headless fallbacks: ``save_path`` ending in .png -> matplotlib render;
    .pcd/.ply -> point-cloud file (open3d writer when available, ASCII .ply
    otherwise).  Returns the written path, if any.
    """
    pc = np.asarray(pc, np.float32)
    try:
        import open3d as o3d  # type: ignore

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pc.astype(np.float64))
        pcd.colors = o3d.utility.Vector3dVector(
            np.clip(np.asarray(rgb, np.float64) / 255.0, 0, 1))
        if save_path is not None:
            save_path = Path(save_path)
            if save_path.suffix == ".png":
                vis = o3d.visualization.Visualizer()
                vis.create_window(visible=False)
                vis.add_geometry(pcd)
                vis.capture_screen_image(str(save_path), do_render=True)
                vis.destroy_window()
            else:
                o3d.io.write_point_cloud(str(save_path), pcd)
            return save_path
        vis = o3d.visualization.Visualizer()
        vis.create_window()
        vis.add_geometry(pcd)
        vis.run()
        vis.destroy_window()
        return None
    except ImportError:
        pass

    if save_path is None:
        save_path = Path("map_3d.png")
    save_path = Path(save_path)
    if save_path.suffix == ".png":
        try:
            _matplotlib_scatter(pc, np.asarray(rgb), save_path)
            return save_path
        except ImportError:
            save_path = save_path.with_suffix(".ply")
    write_ply(save_path, pc, rgb)
    return save_path


def visualize_heatmap_3d(pc: np.ndarray, heatmap: np.ndarray,
                         rgb: np.ndarray, transparency: float = 0.5,
                         save_path: Optional[Union[str, Path]] = None
                         ) -> Optional[Path]:
    """JET-blended heatmap over the 3D map (reference visualize_heatmap_3d,
    visualize_utils.py:68-75)."""
    heat_rgb = convert_heatmap_to_rgb(heatmap, rgb, transparency)
    return visualize_rgb_map_3d(pc, heat_rgb, save_path)


def visualize_masked_map_3d(pc: np.ndarray, mask: np.ndarray,
                            rgb: np.ndarray, transparency: float = 0.5,
                            save_path: Optional[Union[str, Path]] = None
                            ) -> Optional[Path]:
    """Binary-mask variant (reference visualize_masked_map_3d,
    visualize_utils.py:52-57)."""
    return visualize_heatmap_3d(pc, mask.astype(np.float32), rgb,
                                transparency, save_path)


# ---------------------------------------------------------------------------
# segmentation palettes (reference mapping_utils.py:254-303)
# ---------------------------------------------------------------------------


def get_new_palette(num_cls: int) -> list:
    """VOC-style bit-shuffled class palette, identical to the reference's
    get_new_pallete (mapping_utils.py:254-279): flat [r0, g0, b0, r1, ...]."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab = j
        i = 0
        while lab > 0:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette


def get_new_mask_palette(npimg: np.ndarray, new_palette: list,
                         out_label_flag: bool = False, labels=None,
                         ignore_ids_list=()):
    """Colourised label mask + legend patches (reference
    get_new_mask_pallete, mapping_utils.py:281-303).

    Returns (PIL paletted image, list of matplotlib legend patches — empty
    unless ``out_label_flag``)."""
    from PIL import Image

    out_img = Image.fromarray(np.squeeze(npimg).astype("uint8"))
    out_img.putpalette(new_palette)
    patches = []
    if out_label_flag:
        assert labels is not None
        import matplotlib.patches as mpatches

        for index in np.unique(npimg):
            if index in ignore_ids_list:
                continue
            color = [new_palette[index * 3 + k] / 255.0 for k in range(3)]
            patches.append(mpatches.Patch(color=color, label=labels[index]))
    return out_img, patches
