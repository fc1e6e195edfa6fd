"""Rigid-body pose transforms.

Reference semantics: avlmaps/utils/mapping_utils.py:18-26 (pose vec -> TF),
:379-389 (rot mat -> heading theta), the base-frame conjugation of
avlmaps/dataloader/habitat_dataloader.py:115-121 and the config-built base
and camera transforms of avlmaps/map/map.py:54-66.
"""

from __future__ import annotations

import numpy as np


def quat_xyzw_to_matrix(quat: np.ndarray) -> np.ndarray:
    """Convert an (x, y, z, w) quaternion to a 3x3 rotation matrix.

    Matches scipy's ``Rotation.from_quat(...).as_matrix()`` (which the
    reference uses) including normalisation of non-unit quaternions.
    """
    q = np.asarray(quat, dtype=np.float64).reshape(4)
    n = np.linalg.norm(q)
    if n == 0:
        raise ValueError("zero-norm quaternion")
    x, y, z, w = q / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat_xyzw(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (x, y, z, w) quaternion (Shepperd's method)."""
    m = np.asarray(rot, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def pose_vec_to_tf(pos_quat_vec: np.ndarray) -> np.ndarray:
    """(px, py, pz, qx, qy, qz, qw) -> homogeneous 4x4 transform.

    Reference: cvt_pose_vec2tf (mapping_utils.py:18-26).
    """
    vec = np.asarray(pos_quat_vec, dtype=np.float64).reshape(7)
    tf = np.eye(4)
    tf[:3, 3] = vec[:3]
    tf[:3, :3] = quat_xyzw_to_matrix(vec[3:])
    return tf


def tf_to_pose_vec(tf: np.ndarray) -> np.ndarray:
    """Homogeneous 4x4 transform -> (px, py, pz, qx, qy, qz, qw)."""
    tf = np.asarray(tf, dtype=np.float64)
    return np.concatenate([tf[:3, 3], matrix_to_quat_xyzw(tf[:3, :3])])


def base_rot_mat_to_theta(rot_mat: np.ndarray) -> float:
    """Heading angle (rad) of a base rotation, x forward / y left / z up.

    Reference: base_rot_mat2theta (mapping_utils.py:379-389).
    """
    return float(np.arctan2(rot_mat[1, 0], rot_mat[0, 0]))


def theta_to_tf2d(theta: float, translation=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Planar heading + translation -> 4x4 transform (rotation about z)."""
    tf = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    tf[0, 0] = c
    tf[1, 1] = c
    tf[0, 1] = -s
    tf[1, 0] = s
    tf[:3, 3] = translation
    return tf


def conjugate_base_tf(base_transform: np.ndarray,
                      pose_tf: np.ndarray) -> np.ndarray:
    """Express a recorded pose in the canonical mobile-base axes.

    ``base_transform @ pose @ base_transform^-1`` — the conjugation the
    reference applies to every habitat pose (vlmap_builder.py:66-69,106-108;
    habitat_dataloader.py:115-121).
    """
    return base_transform @ pose_tf @ np.linalg.inv(base_transform)


def build_base2cam_tf(base2cam_rot, camera_height: float) -> np.ndarray:
    """Base->camera transform from config (reference map/map.py:54-61)."""
    tf = np.eye(4)
    tf[:3, :3] = np.asarray(base2cam_rot, dtype=np.float64).reshape(3, 3)
    tf[1, 3] = camera_height
    return tf


def build_base_transform(forward_axis, left_axis, up_axis) -> np.ndarray:
    """Base-axes transform from config (reference map/map.py:62-66)."""
    tf = np.eye(4)
    tf[0, :3] = np.asarray(forward_axis, dtype=np.float64)
    tf[1, :3] = np.asarray(left_axis, dtype=np.float64)
    tf[2, :3] = np.asarray(up_axis, dtype=np.float64)
    return tf
