"""Discrete navigation controller: waypoints -> turn/forward action strings.

Counterpart of ``avlmaps_tpu/nav/controller.py``; mirrors reference
avlmaps/controller/controller.py (base) and discrete_nav_controller.py
(turn_angle=5 deg, forward_dist=0.1 m quantisation with pose prediction per
action).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from avlmaps_torch.config import ControllerConfig
from avlmaps_torch.geometry.grid import (base_pos_to_grid_id_scalar,
                                         grid_id_to_base_pos)


class NavController:
    """Abstract controller (reference controller.py:7-32)."""

    def __init__(self, controller_config: ControllerConfig):
        self.config = controller_config

    def convert_goal_to_actions(self, start_pose, goal):
        raise NotImplementedError

    def predict_poses_with_actions(self, start_pose, actions_list):
        raise NotImplementedError

    def convert_paths_to_actions(self, start_pose, paths):
        raise NotImplementedError

    @staticmethod
    def _normalize_angle(angle_deg: float) -> float:
        if angle_deg < -180:
            angle_deg += 360
        elif angle_deg > 180:
            angle_deg -= 360
        return angle_deg

    @staticmethod
    def _compute_dist(sx, sy, gx, gy) -> float:
        return float(np.hypot(gx - sx, gy - sy))


class DiscreteNavController(NavController):
    """turn_left / turn_right / move_forward quantisation
    (reference discrete_nav_controller.py:10-125)."""

    def __init__(self, controller_config: ControllerConfig):
        super().__init__(controller_config)
        self.forward_dist = controller_config.forward_dist
        self.turn_angle_deg = controller_config.turn_angle
        self.gs = controller_config.gs
        self.cs = controller_config.cs

    def convert_goal_to_actions(self, start_pose: Tuple[float, float, float],
                                goal: Tuple[float, float]) -> List[str]:
        """start_pose: (row, col, angle_deg) on the full map (0 deg = up,
        ccw positive); goal: (row, col)."""
        actions: List[str] = []
        cx, cy, _ = grid_id_to_base_pos(start_pose[0], start_pose[1], 0,
                                        self.cs, self.gs)
        heading = start_pose[2]
        gx, gy, _ = grid_id_to_base_pos(goal[0], goal[1], 0, self.cs, self.gs)

        dx, dy = gx - cx, gy - cy
        turn_right = self._normalize_angle(
            np.mod(heading - np.degrees(np.arctan2(dy, dx)), 360))
        dist = float(np.hypot(dx, dy))

        turn_times = int(abs(round(turn_right / self.turn_angle_deg)))
        actions += (["turn_right"] if turn_right > 0 else
                    ["turn_left"]) * turn_times
        forward_times = int(abs(round(dist / self.forward_dist)))
        actions += ["move_forward"] * forward_times
        return actions

    def predict_poses_with_actions(self, start_pose, actions_list):
        """Predicted (x, y, angle_deg) base pose after each action
        (reference :75-98)."""
        poses = []
        cx, cy, _ = grid_id_to_base_pos(start_pose[0], start_pose[1], 0,
                                        self.cs, self.gs)
        ang = start_pose[2]
        for action in actions_list:
            if action == "move_forward":
                cx += np.cos(np.deg2rad(ang)) * self.forward_dist
                cy += np.sin(np.deg2rad(ang)) * self.forward_dist
            elif action == "turn_left":
                ang += self.turn_angle_deg
            elif action == "turn_right":
                ang -= self.turn_angle_deg
            poses.append([cx, cy, ang])
        return poses

    def convert_paths_to_actions(self, start_pose, paths):
        """Waypoints -> (actions, predicted poses), re-basing the pose on
        the prediction after each subgoal (reference :100-125)."""
        actions_list: List[str] = []
        poses_list: List[List[float]] = []
        curr_pose = tuple(start_pose)
        for subgoal in paths:
            sub_actions = self.convert_goal_to_actions(curr_pose, subgoal)
            sub_poses = self.predict_poses_with_actions(curr_pose,
                                                        sub_actions)
            actions_list.extend(sub_actions)
            poses_list.extend(sub_poses)
            if sub_poses:
                row, col, _ = base_pos_to_grid_id_scalar(
                    self.gs, self.cs, sub_poses[-1][0], sub_poses[-1][1], 0)
                curr_pose = (row, col, sub_poses[-1][2])
        return actions_list, poses_list
