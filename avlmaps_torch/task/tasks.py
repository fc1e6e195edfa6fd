"""Navigation task loading + replay evaluation.

Counterpart of ``avlmaps_tpu/task/tasks.py``; mirrors reference avlmaps/task/:
HabitatTask replays recorded action lists through the simulator and scores stop
positions against goal sets (habitat_task.py:32-96); object-goal and
spatial-goal variants load their task JSONs and dump per-task metrics
(habitat_object_nav_task.py, habitat_spatial_goal_nav_task.py).  Runs against
any robot/sim.py Simulator.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from avlmaps_torch.config import AVLMapsConfig
from avlmaps_torch.dataloader.habitat_dataloader import VLMapsDataloaderHabitat
from avlmaps_torch.map.map_base import get_dist_to_bbox_2d
from avlmaps_torch.robot.sim import Simulator

ACTIONS = {"move_forward", "turn_left", "turn_right"}


class HabitatTask:
    def __init__(self, config: AVLMapsConfig):
        self.config = config
        self.goals: List[List[Tuple[float, float]]] = []
        self.reset_metrics()

    def setup_scene(self, vlmaps_dataloader: VLMapsDataloaderHabitat):
        self.vlmaps_dataloader = vlmaps_dataloader

    def load_task(self):
        raise NotImplementedError

    def reset_metrics(self):
        self.n_tot_tasks = 0
        self.n_success_tasks = 0
        self.n_tot_subgoals = 0
        self.n_success_subgoals = 0

    # -- replay evaluation (reference habitat_task.py:32-61) ----------------

    def test_actions(self, sim: Simulator, init_tf: np.ndarray,
                     actions_list: List[str]) -> Tuple[List[bool],
                                                       List[float]]:
        """Replay actions; each 'stop' is scored against the next goal set."""
        sim.set_agent_tf(init_tf)
        success_list = [False] * len(self.goals)
        min_dist_list = [-1.0] * len(self.goals)
        stops = 0
        for action in actions_list:
            if action == "stop":
                goal_id = stops
                stops += 1
                if goal_id >= len(self.goals):
                    continue
                self.vlmaps_dataloader.from_habitat_tf(sim.get_agent_tf())
                row, col, _ = self.vlmaps_dataloader.to_full_map_pose()
                ok, dist = self._check_reached_goal_positions(
                    (row, col), self.goals[goal_id])
                success_list[goal_id] = ok
                min_dist_list[goal_id] = dist
            elif action in ACTIONS:
                sim.step(action)
        return success_list, min_dist_list

    # -- metric helpers (reference habitat_task.py:63-96) -------------------

    def _check_min_dist_to_goal_positions(self, checked_pos,
                                          goal_positions) -> float:
        row, col = checked_pos
        gp = np.asarray(goal_positions, np.float64)
        dists = np.hypot(gp[:, 0] - row, gp[:, 1] - col)
        return float(dists.min()) * self.vlmaps_dataloader.cs

    def _check_reached_goal_positions(self, checked_pos, goal_positions):
        d = self._check_min_dist_to_goal_positions(checked_pos,
                                                   goal_positions)
        return d < self.config.nav.valid_range, d

    def _check_min_dist_to_goal_tfs(self, checked_tf, goal_tfs) -> float:
        pos = checked_tf[:3, 3]
        return float(min(np.linalg.norm(np.asarray(g)[:3, 3] - pos)
                         for g in goal_tfs))

    def _check_reached_goal_tfs(self, checked_tf, goal_tfs):
        d = self._check_min_dist_to_goal_tfs(checked_tf, goal_tfs)
        return d < self.config.nav.valid_range, d


class HabitatObjectNavigationTask(HabitatTask):
    """Object-goal task from object_navigation_tasks.json
    (reference habitat_object_nav_task.py)."""

    def load_task(self):
        task_path = Path(self.vlmaps_dataloader.data_dir) \
            / "object_navigation_tasks.json"
        with open(task_path) as f:
            self.task_dict = json.load(f)

    def setup_task(self, task_id: int):
        entry = self.task_dict[task_id]
        assert entry["task_id"] == task_id, "Task ID mismatch"
        self.task_id = task_id
        self.init_hab_tf = np.asarray(entry["tf_habitat"],
                                      np.float32).reshape(4, 4)
        self.scene = entry.get("scene", "")
        self.instruction = entry.get("instruction", "")
        self.goal_classes = [x["name"] for x in entry["objects_info"]]
        self.goal_objects = entry.get("objects_info", [])
        self.n_subgoals_in_task = len(self.goal_classes)
        self.curr_subgoal_id = 0
        self.finished_subgoals: List[int] = []
        self.distance_to_subgoals: List[float] = []
        self.success = False
        self.actions: List[str] = []

    def _closest_goal_dist(self, class_name: str,
                           pos_hab: np.ndarray) -> float:
        """Distance from the agent to the nearest GT instance of the class.

        The reference queries the live habitat semantic scene
        (get_position_floor_objects); here GT instances come from the task
        JSON's objects_info (center + size boxes), which works with any sim.
        """
        dists = []
        for obj in self.goal_objects:
            if obj["name"] != class_name:
                continue
            center = np.asarray(obj["center"], np.float64)
            size = np.asarray(obj.get("size", [0.5, 0.5, 0.5]), np.float64)
            dists.append(get_dist_to_bbox_2d(center[[0, 2]], size[[0, 2]],
                                             pos_hab[[0, 2]]))
        return float(min(dists)) if dists else np.inf

    def test_step(self, sim: Simulator, action: str,
                  agent_position: Optional[np.ndarray] = None):
        """(reference habitat_object_nav_task.py:80-108)."""
        self.actions.append(action)
        if action == "stop":
            if agent_position is None:
                agent_position = sim.get_agent_tf()[:3, 3]
            name = self.goal_classes[self.curr_subgoal_id]
            dist = self._closest_goal_dist(name, agent_position)
            self.distance_to_subgoals.append(dist)
            if dist < self.config.nav.valid_range:
                self.finished_subgoals.append(self.curr_subgoal_id)
            self.curr_subgoal_id += 1
        elif action in ACTIONS:
            sim.step(action)
        if self.is_task_finished():
            self.n_tot_tasks += 1
            self.n_tot_subgoals += self.n_subgoals_in_task
            self.n_success_subgoals += len(self.finished_subgoals)
            if len(self.finished_subgoals) == self.n_subgoals_in_task:
                self.success = True
                self.n_success_tasks += 1
            self.subgoal_success_rate = (len(self.finished_subgoals)
                                         / self.n_subgoals_in_task)

    def is_task_finished(self) -> bool:
        return self.curr_subgoal_id == self.n_subgoals_in_task

    def save_single_task_metric(self, save_path: Union[Path, str],
                                forward_dist: float = 0.05,
                                turn_angle: float = 1.0):
        """(reference habitat_object_nav_task.py:110-130)."""
        results = {
            "task_id": self.task_id,
            "scene": self.scene,
            "num_subgoals": self.n_subgoals_in_task,
            "subgoal_success_rate": self.subgoal_success_rate,
            "finished_subgoal_ids": self.finished_subgoals,
            "distance_to_subgoals": self.distance_to_subgoals,
            "goal_classes": self.goal_classes,
            "instruction": self.instruction,
            "forward_dist": forward_dist,
            "turn_angle": turn_angle,
            "init_tf_hab": self.init_hab_tf.tolist(),
            "actions": self.actions,
        }
        with open(save_path, "w") as f:
            json.dump(results, f, indent=4)


class HabitatSpatialGoalNavigationTask(HabitatTask):
    """Spatial-goal task from spatial_goal_navigation_tasks.json: goals are
    map position sets (reference habitat_spatial_goal_nav_task.py)."""

    def load_task(self):
        task_path = Path(self.vlmaps_dataloader.data_dir) \
            / "spatial_goal_navigation_tasks.json"
        with open(task_path) as f:
            self.task_dict = json.load(f)

    def setup_task(self, task_id: int):
        entry = self.task_dict[task_id]
        self.task_id = task_id
        self.init_hab_tf = np.asarray(entry["tf_habitat"],
                                      np.float32).reshape(4, 4)
        self.instruction = entry.get("instruction", "")
        self.goals = entry["goals"]  # list of lists of (row, col)
        self.n_subgoals_in_task = len(self.goals)
        self.finished_subgoals = []
        self.distance_to_subgoals = []
        self.actions = []
        self.success = False

    def test_task(self, sim: Simulator,
                  actions_list: List[str]) -> Dict[str, object]:
        """Replay + aggregate metrics."""
        success_list, dists = self.test_actions(sim, self.init_hab_tf,
                                                actions_list)
        self.finished_subgoals = [i for i, ok in enumerate(success_list)
                                  if ok]
        self.distance_to_subgoals = dists
        self.n_tot_tasks += 1
        self.n_tot_subgoals += len(self.goals)
        self.n_success_subgoals += len(self.finished_subgoals)
        self.success = len(self.finished_subgoals) == len(self.goals)
        if self.success:
            self.n_success_tasks += 1
        return {
            "task_id": self.task_id,
            "success": self.success,
            "subgoal_success": success_list,
            "distances": dists,
        }

    def save_single_task_metric(self, save_path: Union[Path, str]):
        results = {
            "task_id": self.task_id,
            "num_subgoals": self.n_subgoals_in_task,
            "finished_subgoal_ids": self.finished_subgoals,
            "distance_to_subgoals": self.distance_to_subgoals,
            "instruction": self.instruction,
            "init_tf_hab": self.init_hab_tf.tolist(),
            "actions": self.actions,
        }
        with open(save_path, "w") as f:
            json.dump(results, f, indent=4)
