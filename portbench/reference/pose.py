"""The image query's pose from its matches, as AVLMaps computes it
(``utils/localization_utils.py``, ``_get_relative_pose_with_depth``):
the matched pixels of the mapping frame lifted to 3-D by its depth, a
RANSAC PnP against the query's pixels, and the query camera composed from
the frame's camera pose.  Plain numpy and OpenCV; poses in the habitat
camera frame (x right, y up, z backward) as 4 x 4 float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from portbench.data import scene as scene_data

# habitat camera <-> OpenCV camera (x right, y down, z forward)
HAB2CV = np.diag([1.0, -1.0, -1.0, 1.0])


def camera_tf(pose_vec: np.ndarray, pose_info: Dict) -> np.ndarray:
    """A habitat base pose (x, y, z, qx, qy, qz, qw) -> its camera's pose:
    the base raised by the sensor height."""
    tf = scene_data.pose_vec_to_tf(pose_vec)
    tf[1, 3] += pose_info["camera_height"]
    return tf


def fov_intrinsics(h: int, w: int, fov_deg: float = 90.0) -> np.ndarray:
    """The query's pinhole intrinsics from a horizontal field of view."""
    f = w / (2.0 * np.tan(np.deg2rad(fov_deg / 2)))
    return np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])


def pnp_pose(ref_xy: np.ndarray, q_xy: np.ndarray, depth: np.ndarray,
             calib: np.ndarray, query_intr: np.ndarray,
             ref_cam: np.ndarray, min_matches: int = 12,
             reproj_px: float = 12.0, iters: int = 200
             ) -> Optional[np.ndarray]:
    """The query camera's pose from ``ref_xy`` (N, 2) pixels of the
    mapping frame matched to ``q_xy`` (N, 2) of the query; None where
    fewer than ``min_matches`` pairs have depth above 5 cm, the solve
    fails, or it keeps fewer than half that many inliers.  Pixel centres
    are at +0.5 on both sides."""
    import cv2

    h, w = depth.shape
    inv_k = np.linalg.inv(calib)
    obj, img = [], []
    for (u, v), (qu, qv) in zip(np.asarray(ref_xy, np.float64),
                                np.asarray(q_xy, np.float64)):
        ui, vi = int(round(u)), int(round(v))
        if not (0 <= ui < w and 0 <= vi < h):
            continue
        z = float(depth[vi, ui])
        if not (np.isfinite(z) and z > 0.05):
            continue
        obj.append((inv_k @ np.array([u + 0.5, v + 0.5, 1.0])) * z)
        img.append((qu + 0.5, qv + 0.5))
    if len(obj) < min_matches:
        return None
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        np.asarray(obj, np.float64), np.asarray(img, np.float64),
        np.asarray(query_intr, np.float64), None,
        reprojectionError=reproj_px, iterationsCount=iters,
        flags=cv2.SOLVEPNP_ITERATIVE)
    if not ok or inliers is None or len(inliers) < min_matches // 2:
        return None
    # the solve maps the frame's (OpenCV) camera into the query's
    t = np.eye(4)
    t[:3, :3] = cv2.Rodrigues(rvec)[0]
    t[:3, 3] = np.asarray(tvec, np.float64).reshape(3)
    return ref_cam @ HAB2CV @ np.linalg.inv(t) @ np.linalg.inv(HAB2CV)
