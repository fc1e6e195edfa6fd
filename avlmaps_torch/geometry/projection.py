"""Camera intrinsics, depth backprojection, point transforms and projection.

Counterpart of ``avlmaps_tpu/geometry/projection.py`` (reference semantics:
avlmaps/utils/mapping_utils.py:226-251, 305-315, 591-622).  Point clouds
are (..., 3) row vectors; the intrinsics and ``project_points`` are numpy
on the host, as the JAX package's are.  The 3x3 contractions on tensors
are written out as three f32 multiply-adds rather than a matmul, so they
stay exact f32 under any TF32 setting and sum in one fixed order on every
device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_sim_cam_mat(h: int, w: int) -> np.ndarray:
    """Simulator-style pinhole intrinsics with fx = fy = w/2
    (reference mapping_utils.py:591-596)."""
    cam_mat = np.eye(3)
    cam_mat[0, 0] = cam_mat[1, 1] = w / 2.0
    cam_mat[0, 2] = w / 2.0
    cam_mat[1, 2] = h / 2.0
    return cam_mat


def get_sim_cam_mat_with_fov(h: int, w: int, fov: float) -> np.ndarray:
    """Pinhole intrinsics from a horizontal FOV in degrees
    (reference mapping_utils.py:617-622)."""
    cam_mat = np.eye(3)
    cam_mat[0, 0] = cam_mat[1, 1] = w / (2.0 * np.tan(np.deg2rad(fov / 2)))
    cam_mat[0, 2] = w / 2.0
    cam_mat[1, 2] = h / 2.0
    return cam_mat


def project_points(cam_mat: np.ndarray, points: np.ndarray):
    """Project (N, 3) camera-frame points to integer pixel coords on the
    host: perspective divide, then ``int(u - 0.5)``, which truncates
    toward zero (not ``floor``), as the reference's project_points does
    (mapping_utils.py:599-614).  Returns (x (N,), y (N,), z (N,))."""
    uvw = points @ cam_mat.T
    z = uvw[:, 2]
    uv = uvw[:, :2] / uvw[:, 2:3]
    x = (uv[:, 0] - 0.5).astype(int)
    y = (uv[:, 1] - 0.5).astype(int)
    return x, y, z


def apply_mat3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = sum_j m[..., i, j] * v[..., j]``.

    ``m``: (3, 3), or (B, 3, 3) with ``v`` of shape (B, N, 3)."""
    if m.dim() == 3:
        m = m[:, None]  # (B, 1, 3, 3) against (B, N, 3)
    return (v[..., 0:1] * m[..., 0] + v[..., 1:2] * m[..., 1]
            + v[..., 2:3] * m[..., 2])


def depth_to_pointcloud(depth: torch.Tensor, inv_intr: torch.Tensor,
                        min_depth: float = 0.1, max_depth: float = 6.0):
    """Backproject an (h, w) f32 depth image with the (3, 3) INVERSE
    intrinsics; pixel centres at +0.5.  Returns ``(points (h*w, 3) f32,
    mask (h*w,) bool)``; out-of-range depths are masked, not dropped."""
    h, w = depth.shape
    dev = depth.device
    ys = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    uv1 = torch.stack([xx.reshape(-1), yy.reshape(-1),
                       torch.ones(h * w, device=dev)], dim=-1)
    pc = apply_mat3(inv_intr.float(), uv1) * depth.reshape(-1, 1)
    z = pc[:, 2]
    return pc, (z > min_depth) & (z < max_depth)


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 pose to (N, 3) points."""
    return apply_mat3(pose[:3, :3], points) + pose[:3, 3]
