"""A seeded RGB-D walk through a furnished room, in the dataset's layout.

The room is a box (floor, walls, ceiling) with boxes standing on its
floor, each surface with its own colour and a texture fixed in the
world, so consecutive frames see the same surfaces and the map reuses
their voxels as a real walk does.  The camera walks a circle: 5 cm
forward and 1 degree of yaw a frame, at the configuration's camera
height.  Depth is the camera-frame z of the first surface hit by each
pixel's ray (the convention ``depth * K^-1 (u + 0.5, v + 0.5, 1)``
inverts), so the map's points land on the surfaces.

The camera-to-map transform of each frame is the builders' formula
(reference ``vlmap_builder.py:106-133``), kept here as the benchmark's
own copy; the reference takes it from here too.

``ensure_scene`` writes ``rgb/*.png``, ``depth/*.npy`` and ``poses.txt``
once per checkout under a fixed cache directory, and the ``.avpack``
beside it with the port's ``pack_scene``.  ``ensure_walk`` lays a longer
sequence over the rendered frames: a robot that walks the path, turns
back and walks it again (``walk_order``), each entry a link to its
source frame's files with the source's pose, packed whole.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np


# -- poses and camera (the benchmark's copy of the builders' formula) -----

def quat_xyzw_to_matrix(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def pose_vec_to_tf(vec) -> np.ndarray:
    tf = np.eye(4)
    tf[:3, 3] = np.asarray(vec[:3], np.float64)
    tf[:3, :3] = quat_xyzw_to_matrix(vec[3:7])
    return tf


def base_transforms(pose_info: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(base2cam_tf, base_transform) of the map configuration's
    ``pose_info``."""
    b2c = np.eye(4)
    b2c[:3, :3] = np.asarray(pose_info["base2cam_rot"], np.float64) \
        .reshape(3, 3)
    b2c[1, 3] = pose_info["camera_height"]
    bt = np.eye(4)
    bt[0, :3] = pose_info["base_forward_axis"]
    bt[1, :3] = pose_info["base_left_axis"]
    bt[2, :3] = pose_info["base_up_axis"]
    return b2c, bt


def cam_to_map(pose_vecs: np.ndarray, pose_info: Dict) -> np.ndarray:
    """(N, 4, 4) float64 camera-to-map transforms of mobile-base poses."""
    b2c, bt = base_transforms(pose_info)
    inv_bt = np.linalg.inv(bt)
    init = bt @ pose_vec_to_tf(pose_vecs[0]) @ inv_bt
    inv_init = np.linalg.inv(init)
    return np.stack([inv_init @ (bt @ pose_vec_to_tf(v) @ inv_bt) @ bt @ b2c
                     for v in pose_vecs])


def walk_poses(n: int, step_m: float, yaw_deg: float) -> np.ndarray:
    """(n, 7) habitat poses (x, y, z, qx, qy, qz, qw; y up, forward -z):
    ``step_m`` forward then ``yaw_deg`` to the left, frame by frame."""
    out = np.zeros((n, 7))
    x = z = 0.0
    for i in range(n):
        th = np.deg2rad(yaw_deg * i)
        out[i] = [x, 0.0, z, 0.0, np.sin(th / 2), 0.0, np.cos(th / 2)]
        x -= step_m * np.sin(th)
        z -= step_m * np.cos(th)
    return out


def calib_matrix(map_cfg: Dict) -> np.ndarray:
    return np.asarray(map_cfg["cam_calib_mat"], np.float64).reshape(3, 3)


# -- the room ---------------------------------------------------------------

def room_layout(p: Dict) -> Dict:
    """The room box and the furniture boxes, in map coordinates (x
    forward of the first frame, y left, z up), from ``scene_seed``.  The
    walk's circle has its centre at (0, r) with r = step / yaw."""
    rng = np.random.default_rng(p["scene_seed"])
    r = p["step_m"] / np.deg2rad(p["yaw_deg"])
    half = p["room_m"] / 2
    # walls off the cell lattice, as a real room's are, so no surface
    # sits on a cell boundary where rounding alone picks its cell
    off = rng.uniform(0.1, 0.9, 2) * 0.05
    lo = np.array([-half + off[0], r - half + off[1], 0.0])
    hi = np.array([half + off[0], r + half + off[1], p["ceiling_m"]])
    boxes = []
    while len(boxes) < p["boxes"]:
        size = rng.uniform(0.4, 1.4, 2)
        height = rng.uniform(0.4, 1.2)
        c = rng.uniform(lo[:2] + 0.3 + size / 2, hi[:2] - 0.3 - size / 2)
        # keep the walk's band (radius r +- 0.9 m) clear
        near = np.abs(np.hypot(c[0], c[1] - r) - r) < 0.9 + size.max() / 2
        if near:
            continue
        boxes.append(np.concatenate([c - size / 2, [0.0], c + size / 2,
                                     [height]]))
    n_surf = 6 + len(boxes)
    colours = rng.integers(40, 216, (n_surf, 3))
    return {"lo": lo, "hi": hi, "boxes": np.asarray(boxes),
            "colours": colours}


def render(tfs: np.ndarray, calib: np.ndarray, hw: Tuple[int, int],
           layout: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 colour and (N, H, W) f32 depth in metres of the
    frames whose camera-to-map transforms are ``tfs``."""
    import torch

    h, w = hw
    dev = torch.device(device)
    f64 = torch.float64
    inv_k = torch.tensor(np.linalg.inv(calib), dtype=f64, device=dev)
    vv, uu = torch.meshgrid(torch.arange(h, device=dev, dtype=f64),
                            torch.arange(w, device=dev, dtype=f64),
                            indexing="ij")
    pix = torch.stack([uu + 0.5, vv + 0.5, torch.ones_like(uu)], -1)
    d_cam = pix.reshape(-1, 3) @ inv_k.T  # camera-frame z = 1
    lo = torch.tensor(layout["lo"], dtype=f64, device=dev)
    hi = torch.tensor(layout["hi"], dtype=f64, device=dev)
    boxes = torch.tensor(layout["boxes"], dtype=f64, device=dev)
    colours = torch.tensor(layout["colours"], dtype=f64, device=dev)
    rgbs, depths = [], []
    for tf in tfs:
        rot = torch.tensor(tf[:3, :3], dtype=f64, device=dev)
        org = torch.tensor(tf[:3, 3], dtype=f64, device=dev)
        d = d_cam @ rot.T  # (P, 3) map-frame rays, t = camera z
        safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        # inside the room: the nearest exit plane
        t_axes = torch.where(safe > 0, (hi - org) / safe, (lo - org) / safe)
        t, axis = t_axes.min(dim=1)
        positive = torch.gather(safe, 1, axis[:, None])[:, 0] > 0
        surf = torch.where(positive, 2 * axis + 1, 2 * axis)
        # boxes from outside: the slab test
        for bi in range(boxes.shape[0]):
            t1 = (boxes[bi, :3] - org) / safe
            t2 = (boxes[bi, 3:] - org) / safe
            near = torch.minimum(t1, t2).max(dim=1).values
            far = torch.maximum(t1, t2).min(dim=1).values
            hit = (near <= far) & (near > 1e-6) & (near < t)
            t = torch.where(hit, near, t)
            surf = torch.where(hit, torch.full_like(surf, 6 + bi), surf)
        p = org + t[:, None] * d
        # a texture fixed in the world: 4 cm tiles of hashed brightness
        cell = torch.floor(p / 0.04).to(torch.int64)
        hsh = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) \
            ^ (cell[:, 2] * 83492791)
        shade = 0.7 + 0.3 * ((hsh & 255).to(f64) / 255.0)
        stripe = 0.9 + 0.1 * torch.sin(p.sum(dim=1) * 6.0)
        rgb = colours[surf] * (shade * stripe)[:, None]
        rgbs.append(torch.clamp(rgb, 0, 255).to(torch.uint8)
                    .reshape(h, w, 3).cpu().numpy())
        depths.append(t.to(torch.float32).reshape(h, w).cpu().numpy())
    return np.stack(rgbs), np.stack(depths)


# -- the cached scene ------------------------------------------------------

def scene_key(p: Dict, map_cfg: Dict) -> str:
    blob = json.dumps({"scene": p, "pose_info": map_cfg["pose_info"],
                       "calib": map_cfg["cam_calib_mat"]}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _write_png(path: Path, rgb: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(str(path), rgb[..., ::-1])
    except ImportError:
        from PIL import Image

        Image.fromarray(rgb).save(path, compress_level=1)


def ensure_scene(cache_root: Path, p: Dict, map_cfg: Dict, device,
                 pack_canvas_hw=None) -> Dict:
    """The scene's directory (written on the first call in a checkout)
    and, with ``pack_canvas_hw``, its ``.avpack`` beside it (packed by the
    port's ``pack_scene``, as ``create_map --pack-first`` does).  Returns
    paths and the pose vectors."""
    key = scene_key(p, map_cfg)
    root = Path(cache_root) / f"scene-{key}"
    if not (root / "done").exists():
        stage = Path(cache_root) / f"scene-{key}.partial"
        shutil.rmtree(stage, ignore_errors=True)
        (stage / "rgb").mkdir(parents=True)
        (stage / "depth").mkdir()
        poses = walk_poses(p["frames"], p["step_m"], p["yaw_deg"])
        tfs = cam_to_map(poses, map_cfg["pose_info"])
        rgb, depth = render(tfs, calib_matrix(map_cfg), tuple(p["hw"]),
                            room_layout(p), device)
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: _write_png(
                stage / "rgb" / f"{i:06d}.png", rgb[i]), range(len(rgb))))
        for i, d in enumerate(depth):
            np.save(stage / "depth" / f"{i:06d}.npy", d)
        np.savetxt(stage / "poses.txt", poses)
        (stage / "done").write_text("ok\n")
        shutil.rmtree(root, ignore_errors=True)
        stage.rename(root)
    out = {"dir": root, "poses": np.loadtxt(root / "poses.txt"),
           "rgb": sorted((root / "rgb").glob("*.png")),
           "depth": sorted((root / "depth").glob("*.npy"))}
    if pack_canvas_hw is not None:
        out["pack"] = ensure_pack(Path(cache_root), root.name, out,
                                  tuple(pack_canvas_hw))
    return out


def ensure_pack(cache_root: Path, stem: str, scene: Dict,
                canvas_hw: Tuple[int, int]) -> Path:
    from avlmaps_torch.pipeline.packed import pack_scene

    path = cache_root / f"{stem}-{canvas_hw[0]}x{canvas_hw[1]}.avpack"
    if not path.exists():
        stage = path.with_suffix(".partial")
        stage.unlink(missing_ok=True)
        pack_scene(scene["rgb"], scene["depth"], stage, canvas_hw=canvas_hw,
                   depth_dtype="u16mm")
        stage.rename(path)
    return path


def walk_order(n: int, passes: int) -> np.ndarray:
    """The source frame of each entry of a walk of ``passes`` passes over
    ``n`` frames: 0..n-1, then n-1..0, then 0..n-1, and so on."""
    fwd = np.arange(n)
    return np.concatenate([fwd if k % 2 == 0 else fwd[::-1]
                           for k in range(passes)])


def ensure_walk(cache_root: Path, scene: Dict, passes: int,
                pack_canvas_hw) -> Dict:
    """The walk of ``passes`` passes over the rendered ``scene``, laid out
    as a dataset (written on the first call in a checkout): ``rgb/`` and
    ``depth/`` hold one relative link an entry to its source frame's
    file, ``poses.txt`` each entry's source pose, and the ``.avpack`` of
    all the entries beside it.
    Returns what ``ensure_scene`` does, with ``src``: each entry's
    source frame, and ``frames``: the rendered frames' paths."""
    src_dir = Path(scene["dir"])
    order = walk_order(len(scene["rgb"]), passes)
    root = Path(cache_root) / f"{src_dir.name}-walk{passes}"
    if not (root / "done").exists():
        stage = root.with_name(root.name + ".partial")
        shutil.rmtree(stage, ignore_errors=True)
        for kind, files in (("rgb", scene["rgb"]), ("depth", scene["depth"])):
            (stage / kind).mkdir(parents=True)
            for i, s in enumerate(order):
                f = Path(files[s])
                (stage / kind / f"{i:06d}{f.suffix}").symlink_to(
                    Path("..", "..", src_dir.name, kind, f.name))
        np.savetxt(stage / "poses.txt", scene["poses"][order])
        (stage / "done").write_text("ok\n")
        shutil.rmtree(root, ignore_errors=True)
        stage.rename(root)
    out = {"dir": root, "poses": np.loadtxt(root / "poses.txt"),
           "rgb": sorted((root / "rgb").glob("*.png")),
           "depth": sorted((root / "depth").glob("*.npy")),
           "src": order, "frames": scene}
    out["pack"] = ensure_pack(Path(cache_root), root.name, out,
                              tuple(pack_canvas_hw))
    return out


def read_through(path: Path, block: int = 64 << 20) -> int:
    """Read a file once from end to end, so that its pages sit in the
    host's page cache; returns its bytes."""
    buf = bytearray(block)
    n = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            got = f.readinto(buf)
            if not got:
                return n
            n += got


def load_frames(scene: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The scene's frames as the files hold them: (N, H, W, 3) uint8 RGB,
    (N, H, W) f32 depth (the reference reads these)."""
    from PIL import Image

    rgb = np.stack([np.asarray(Image.open(f).convert("RGB"))
                    for f in scene["rgb"]])
    depth = np.stack([np.load(f) for f in scene["depth"]])
    return rgb, depth
