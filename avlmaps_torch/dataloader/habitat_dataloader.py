"""Pose converter between the simulator (habitat) frame, the full-map grid
pose and the cropped-map grid pose.

Counterpart of ``avlmaps_tpu/dataloader/habitat_dataloader.py`` (reference
avlmaps/dataloader/habitat_dataloader.py): the full map pose is (row, col,
angle_deg) with angle 0 pointing up (negative row) and the cropped pose is
shifted by (rmin, cmin).  Host numpy throughout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.config import MapConfig
from avlmaps_torch.geometry.grid import (base_pos_to_grid_id_scalar,
                                         grid_id_to_base_pos)
from avlmaps_torch.geometry.transforms import (base_rot_mat_to_theta,
                                               pose_vec_to_tf, theta_to_tf2d)
from avlmaps_torch.map.map_base import Map


class VLMapsDataloaderHabitat:
    """Converter over a loaded map; with ``map=None`` it loads the scene's
    VLMap itself, on ``device`` (default ``"cuda"``; raises without a
    card)."""

    def __init__(self, data_dir: Union[Path, str], map_config: MapConfig,
                 map: Optional[Map] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.data_dir = data_dir
        self.map_config = map_config
        self.cs = map_config.cell_size
        self.gs = map_config.grid_size
        self.camera_height = map_config.pose_info.camera_height

        if map is None:
            from avlmaps_torch.map.vlmap import VLMap

            self.map = VLMap(map_config, device=device)
            load_success = self.map.load_map(data_dir)
            assert load_success, (
                f"Map loading fails. It could be because the map hasn't "
                f"been created at {data_dir}")
            self.map.generate_obstacle_map()
        else:
            self.map = map
            if self.map.obstacles_map is None:
                self.map.generate_obstacle_map()

        self.obstacles = self.map.obstacles_map
        self.obstacles_cropped = self.map.obstacles_cropped
        self.rmin, self.rmax = self.map.rmin, self.map.rmax
        self.cmin, self.cmax = self.map.cmin, self.map.cmax

        self.base2cam_tf = self.map.base2cam_tf
        self.base_transform = self.map.base_transform
        self.base_poses = np.loadtxt(self.map.pose_path)
        if self.base_poses.ndim == 1:
            self.base_poses = self.base_poses[None]
        self.init_base_tf = (
            self.base_transform @ pose_vec_to_tf(self.base_poses[0])
            @ np.linalg.inv(self.base_transform))
        self.inv_init_base_tf = np.linalg.inv(self.init_base_tf)

        self.full_map_pose: Optional[list] = None

    # -- from: set the converter state --------------------------------------

    def from_cropped_map_pose(self, row: int, col: int, theta_deg: float):
        self.full_map_pose = [row + self.rmin, col + self.cmin, theta_deg]

    def from_full_map_pose(self, row: int, col: int, theta_deg: float):
        self.full_map_pose = [row, col, theta_deg]

    def from_habitat_tf(self, tf_hab: np.ndarray):
        """(reference habitat_dataloader.py:115-121)."""
        tf = (self.inv_init_base_tf @ self.base_transform @ tf_hab
              @ np.linalg.inv(self.base_transform))
        theta_deg = np.rad2deg(base_rot_mat_to_theta(tf[:3, :3]))
        x, y, z = tf[:3, 3]
        row, col, _ = base_pos_to_grid_id_scalar(self.gs, self.cs, x, y, z)
        self.full_map_pose = [row, col, theta_deg]

    def from_camera_tf(self, tf_cam: np.ndarray):
        tf_hab = (self.base_transform @ self.inv_init_base_tf
                  @ self.base2cam_tf @ tf_cam)
        self.from_habitat_tf(tf_hab)

    # -- to: read the converter state ---------------------------------------

    def to_cropped_map_pose(self) -> Tuple[int, int, float]:
        assert self.full_map_pose is not None, "Please call from_xx() first."
        return [self.full_map_pose[0] - self.rmin,
                self.full_map_pose[1] - self.cmin, self.full_map_pose[2]]

    def to_full_map_pose(self) -> Tuple[int, int, float]:
        assert self.full_map_pose is not None, "Please call from_xx() first."
        return self.full_map_pose

    def to_habitat_tf(self) -> np.ndarray:
        """(reference habitat_dataloader.py:135-147)."""
        assert self.full_map_pose is not None, "Please call from_xx() first."
        row, col, theta_deg = self.full_map_pose
        x, y, z = grid_id_to_base_pos(row, col, 0, self.cs, self.gs)
        tf = theta_to_tf2d(np.deg2rad(theta_deg), (x, y, z))
        return (np.linalg.inv(self.base_transform) @ self.init_base_tf @ tf
                @ self.base_transform)

    # -- conveniences -------------------------------------------------------

    def get_obstacles_cropped(self) -> np.ndarray:
        return self.obstacles_cropped

    def get_color_topdown_cropped(self) -> np.ndarray:
        color = self.map.generate_rgb_topdown_map()
        return color[self.rmin:self.rmax + 1, self.cmin:self.cmax + 1]
