"""LangRobot: the language-primitive robot API (the LLM codegen target).

Counterpart of ``avlmaps_tpu/robot/lang_robot.py``; mirrors reference
avlmaps/robot/lang_robot.py:17-201: every primitive resolves a goal
position through the map's spatial reasoning and delegates to ``move_to``
/ ``turn``, which concrete robots implement.  The maps the robot loads
(and their CLIP and AudioCLIP encoders) run on ``device`` (default
``"cuda"``; raises without a card).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.config import AVLMapsConfig
from avlmaps_torch.map.map_base import Map
from avlmaps_torch.map.sound_map import SoundMap
from avlmaps_torch.utils.device import resolve_device


class LangRobot:
    def __init__(self, config: AVLMapsConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.curr_pos_on_map: Optional[Tuple[float, float]] = None
        self.curr_ang_deg_on_map: Optional[float] = None
        self.map: Optional[Map] = None
        self.sound_map: Optional[SoundMap] = None
        self.recorded_actions_list: List[str] = []
        self.recorded_robot_pos: List[Tuple[float, float]] = []
        self.goal_tfs = None
        self.all_goal_tfs = None
        self.goal_id = None

    # -- scene wiring (reference :31-43) ------------------------------------

    def load_scene_map(self, data_dir: str, map_config) -> None:
        self.map = Map.create(map_config, device=self.device)
        self.map.load_map(data_dir)
        self.map.generate_obstacle_map()

    def load_sound_map(self, avlmaps_data_dir: str,
                       is_real: bool = False) -> None:
        self.sound_map = SoundMap(
            avlmaps_data_dir, self.config.sound_config,
            self.config.sound_data_collect_params,
            is_ambiguous=self.config.sound_data_collect_params
            .is_ambiguous_data,
            is_real=is_real, device=self.device)
        self.sound_map.load_sound_map(avlmaps_data_dir)

    # -- recording (reference :45-60) ---------------------------------------

    def empty_recorded_actions(self):
        self.recorded_actions_list = []
        self.recorded_robot_pos = []
        self.goal_tfs = None
        self.all_goal_tfs = None
        self.goal_id = None

    def get_recorded_actions(self) -> List[str]:
        return self.recorded_actions_list

    def load_code(self, code_dir: str, task_i: int) -> str:
        with open(os.path.join(code_dir, f"{task_i:06}.txt")) as f:
            return f.read()

    # -- abstract motion ----------------------------------------------------

    def _set_nav_curr_pose(self):
        raise NotImplementedError

    def execute_actions(self, actions_list: List[Any]):
        raise NotImplementedError

    def _execute_action(self, action: str):
        raise NotImplementedError

    def move_to(self, pos: Tuple[float, float]):
        raise NotImplementedError

    def turn(self, angle_deg: float):
        raise NotImplementedError

    # -- queries (reference :96-137) ----------------------------------------

    def get_agent_pose_on_map(self) -> Tuple[float, float, float]:
        return (self.curr_pos_on_map[0], self.curr_pos_on_map[1],
                self.curr_ang_deg_on_map)

    def get_pos(self, name: str):
        """Nearest instance centre of a named category."""
        contours, centers, bbox_list = self.map.get_pos(name)
        if not centers:
            print(f"no objects {name} detected")
            return self.curr_pos_on_map
        ids = self.map.filter_small_objects(bbox_list)
        if ids:
            centers = [centers[x] for x in ids]
            bbox_list = [bbox_list[x] for x in ids]
        nearest = self.map.select_nearest_obj(centers, bbox_list,
                                              self.curr_pos_on_map)
        return centers[nearest]

    def get_contour(self, name: str):
        contours, centers, bbox_list = self.map.get_pos(name)
        if not centers:
            raise ValueError(f"no objects {name} detected")
        ids = self.map.filter_small_objects(bbox_list)
        if ids:
            centers = [centers[x] for x in ids]
            bbox_list = [bbox_list[x] for x in ids]
            contours = [contours[x] for x in ids]
        nearest = self.map.select_nearest_obj(centers, bbox_list,
                                              self.curr_pos_on_map)
        return contours[nearest]

    def get_sound_pos(self, name: str):
        assert self.sound_map is not None, "sound map not loaded"
        return self.sound_map.get_pos(name)

    # -- language primitives (reference :139-201) ---------------------------

    def with_object_on_left(self, name: str):
        self.face(name)
        self.turn(90)

    def with_object_on_right(self, name: str):
        self.face(name)
        self.turn(-90)

    def move_to_left(self, name: str):
        self._set_nav_curr_pose()
        pos = self.map.get_left_pos(self.curr_pos_on_map,
                                    self.curr_ang_deg_on_map, name)
        self.move_to(pos)

    def move_to_right(self, name: str):
        self._set_nav_curr_pose()
        pos = self.map.get_right_pos(self.curr_pos_on_map,
                                     self.curr_ang_deg_on_map, name)
        self.move_to(pos)

    def move_in_between(self, name_a: str, name_b: str):
        self._set_nav_curr_pose()
        pos = self.map.get_pos_in_between(self.curr_pos_on_map,
                                          self.curr_ang_deg_on_map,
                                          name_a, name_b)
        self.move_to(pos)

    def turn_absolute(self, angle_deg: float):
        self._set_nav_curr_pose()
        self.turn(angle_deg - self.curr_ang_deg_on_map)

    def face(self, name: str):
        self._set_nav_curr_pose()
        turn_right = self.map.get_delta_angle_to(self.curr_pos_on_map,
                                                 self.curr_ang_deg_on_map,
                                                 name)
        self.turn(turn_right)

    def move_north(self, name: str):
        self._move_cardinal("north", name)

    def move_south(self, name: str):
        self._move_cardinal("south", name)

    def move_west(self, name: str):
        self._move_cardinal("west", name)

    def move_east(self, name: str):
        self._move_cardinal("east", name)

    def _move_cardinal(self, direction: str, name: str):
        self._set_nav_curr_pose()
        getter = getattr(self.map, f"get_{direction}_pos")
        pos = getter(self.curr_pos_on_map, self.curr_ang_deg_on_map, name)
        if pos and pos[0] != "stop":
            self.move_to(pos)

    def move_to_object(self, name: str):
        self._set_nav_curr_pose()
        pos = self.map.get_nearest_pos(self.curr_pos_on_map, name)
        self.move_to(pos)

    def move_forward(self, meters: float):
        self._set_nav_curr_pose()
        pos = self.map.get_forward_pos(self.curr_pos_on_map,
                                       self.curr_ang_deg_on_map, meters)
        self.move_to(pos)

    def execute_code(self, code: str) -> None:
        """Run LLM-generated ``robot.*`` code against this robot
        (the codegen target surface, reference llm_utils.py:36-178)."""
        exec(compile(code, "<robot-code>", "exec"),
             {"robot": self, "np": np})
