"""HabitatLanguageRobot: simulator-bound robot with cross-modal goal fusion.

Counterpart of ``avlmaps_tpu/robot/habitat_lang_robot.py``; mirrors reference
avlmaps/robot/habitat_lang_robot.py: scene setup (map + customised obstacles +
visibility graph), GT pose sync from the simulator, plan -> discrete actions ->
sim stepping, and the per-modality distribution maps (decay 0.01 "map" / 0.1
"major map") whose elementwise fusion picks navigation goals.

The simulator is injected (habitat when present, the kinematic fake
otherwise) — see robot/sim.py.  The map's scoring (K8 in
``init_categories``, K7), the heats and the fused goal pick run on
``device`` (default ``"cuda"``; raises without a card); planning and
control stay on the host.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.config import AVLMapsConfig
from avlmaps_torch.dataloader.habitat_dataloader import VLMapsDataloaderHabitat
from avlmaps_torch.geometry.grid import grid_id_to_base_pos_batch
from avlmaps_torch.nav.controller import DiscreteNavController
from avlmaps_torch.nav.navigator import Navigator
from avlmaps_torch.ops.heatmap import heatmap_from_mask_3d
from avlmaps_torch.robot.lang_robot import LangRobot
from avlmaps_torch.robot.sim import (HABITAT_AVAILABLE, HabitatSimulator,
                                     KinematicSimulator, Simulator)
from avlmaps_torch.utils.categories import mp3dcat
from avlmaps_torch.utils.category_matching import find_similar_category_id
from avlmaps_torch.utils.device import to_device


class HabitatLanguageRobot(LangRobot):
    def __init__(self, config: AVLMapsConfig,
                 sim: Optional[Simulator] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(config, device=device)
        data_dir = Path(config.data_paths.avlmaps_data_dir or ".")
        dataset_dir = data_dir / "vlmaps_dataset"
        self.vlmaps_data_save_dirs = sorted(
            [dataset_dir / x for x in os.listdir(dataset_dir)]
        ) if dataset_dir.exists() else []

        self.camera_height = config.params.camera_height
        self.gs = config.params.gs
        self.cs = config.params.cs
        self.forward_dist = config.params.forward_dist
        self.turn_angle = config.params.turn_angle
        self.vis = config.nav.vis

        self.sim = sim
        self.nav = Navigator()
        self.controller = DiscreteNavController(config.controller_config)
        self.vlmaps_dataloader: Optional[VLMapsDataloaderHabitat] = None
        self.global_pc: Optional[np.ndarray] = None
        self._grid_pos_dev: Optional[torch.Tensor] = None

    # -- scene setup (reference :75-146) ------------------------------------

    def setup_scene(self, scene_id: int) -> None:
        avlmaps_data_dir = self.vlmaps_data_save_dirs[scene_id]
        self.scene_id = scene_id
        self.scene_name = avlmaps_data_dir.name.split("_")[0]
        self._setup_sim(self.scene_name)
        self.setup_map(str(avlmaps_data_dir))

        cropped = self.map.get_obstacle_cropped()
        if (self.config.map_config.potential_obstacle_names
                and self.config.map_config.obstacle_names):
            self.map.customize_obstacle_map(
                self.config.map_config.potential_obstacle_names,
                self.config.map_config.obstacle_names, vis=self.vis)
            cropped = self.map.get_customized_obstacle_cropped()
        self.nav.build_visgraph(cropped, self.vlmaps_dataloader.rmin,
                                self.vlmaps_dataloader.cmin, vis=self.vis)

    def setup_map(self, avlmaps_data_dir: str) -> None:
        self.load_scene_map(avlmaps_data_dir, self.config.map_config)
        self.map.init_categories(list(mp3dcat))
        self.global_pc = grid_id_to_base_pos_batch(self.map.grid_pos,
                                                   self.cs, self.gs)
        self.vlmaps_dataloader = VLMapsDataloaderHabitat(
            avlmaps_data_dir, self.config.map_config, map=self.map,
            device=self.device)
        self._data_dir = avlmaps_data_dir
        self._visual_map = None
        self._grid_pos_dev = None  # the voxel positions on the device

    @property
    def visual_map(self):
        """Lazy visual-localization map (first image query pays for the
        descriptor build/cache; reference defers HLoc the same way)."""
        if self._visual_map is None:
            from avlmaps_torch.map.visual_map import VisualMap

            self._visual_map = VisualMap(self.config.map_config,
                                         self._data_dir, device=self.device)
            self._visual_map.create_and_load_map(self._data_dir)
        return self._visual_map

    def _setup_sim(self, scene_name: str) -> None:
        if self.sim is not None:
            return
        if HABITAT_AVAILABLE and self.config.data_paths.habitat_scene_dir:
            scene_path = os.path.join(
                self.config.data_paths.habitat_scene_dir, scene_name,
                f"{scene_name}.glb")
            self.sim = HabitatSimulator(scene_path, {
                "sensor_height": self.camera_height,
                "width": 640, "height": 480,
                "move_forward": self.forward_dist,
                "turn_left": self.turn_angle,
                "turn_right": self.turn_angle,
            })
        else:
            self.sim = KinematicSimulator(self.forward_dist, self.turn_angle)

    # -- agent state (reference :148-156, :538-556) -------------------------

    def set_agent_state(self, tf: np.ndarray) -> None:
        self.sim.set_agent_tf(tf)
        self._set_nav_curr_pose()

    def get_agent_tf(self) -> np.ndarray:
        return self.sim.get_agent_tf()

    def _set_nav_curr_pose(self) -> None:
        self.vlmaps_dataloader.from_habitat_tf(self.sim.get_agent_tf())
        row, col, angle_deg = self.vlmaps_dataloader.to_full_map_pose()
        self.curr_pos_on_map = (row, col)
        self.curr_ang_deg_on_map = angle_deg

    def _get_full_map_pose(self) -> Tuple[float, float, float]:
        self.vlmaps_dataloader.from_habitat_tf(self.sim.get_agent_tf())
        return self.vlmaps_dataloader.to_full_map_pose()

    # -- motion (reference :432-529) ----------------------------------------

    def move_to(self, pos: Tuple[float, float]) -> List[str]:
        """Plan to (row, col) on the full map and execute."""
        self._set_nav_curr_pose()
        curr_pose = self.get_agent_pose_on_map()
        paths = self.nav.plan_to(curr_pose[:2], pos, vis=self.vis)
        actions_list, poses_list = self.controller.convert_paths_to_actions(
            curr_pose, paths[1:])
        success, real_actions = self.execute_actions(actions_list,
                                                     poses_list)
        real_actions.append("stop")
        self.recorded_actions_list.extend(real_actions)
        return real_actions

    def turn(self, angle_deg: float) -> List[str]:
        """Turn right (positive) a relative angle (reference :463-475)."""
        if angle_deg < 0:
            actions = ["turn_left"] * int(abs(angle_deg) / self.turn_angle)
        else:
            actions = ["turn_right"] * int(angle_deg / self.turn_angle)
        _, real_actions = self.execute_actions(actions)
        self.recorded_actions_list.extend(real_actions)
        return real_actions

    def execute_actions(self, actions_list: List[str],
                        poses_list=None) -> Tuple[bool, List[str]]:
        if poses_list is not None:
            assert len(actions_list) == len(poses_list)
        real_actions = []
        for action in actions_list:
            self._execute_action(action)
            real_actions.append(action)
            if poses_list is not None:
                row, col, _ = self._get_full_map_pose()
                self.recorded_robot_pos.append((row, col))
        return True, real_actions

    def _execute_action(self, action: str) -> None:
        self.sim.step(action)

    # -- goal bookkeeping (reference :517-526) ------------------------------

    def pass_goal_bboxes(self, goal_bboxes: Dict[str, Any]):
        self.goal_bboxes = goal_bboxes

    def pass_goal_tf(self, goal_tfs: List[np.ndarray]):
        self.goal_tfs = goal_tfs

    def pass_goal_tf_list(self, goal_tfs):
        self.all_goal_tfs = goal_tfs
        self.goal_id = 0

    # -- distribution maps (reference :183-430) -----------------------------

    def _positions_to_cropped(self, habitat_positions) -> List[List[float]]:
        out = []
        for p in habitat_positions:
            tf = np.eye(4)
            tf[:3, 3] = p
            self.vlmaps_dataloader.from_habitat_tf(tf)
            row, col, _ = self.vlmaps_dataloader.to_cropped_map_pose()
            out.append([row, col])
        return out

    def get_distribution_map(self, name: str, scores: np.ndarray,
                             pos_list_cropped, decay_rate: float = 0.1
                             ) -> np.ndarray:
        """Per-position confidences splatted with radial decay and summed
        on the cropped map (reference :183-216)."""
        scores = np.asarray(scores, np.float32)
        if scores.shape[0] > 1:
            rng = scores.max() - scores.min()
            scores = (scores - scores.min()) / (rng if rng > 0 else 1.0)
        shape = self.map.get_obstacle_cropped().shape
        rows = np.arange(shape[0], dtype=np.float32)[:, None]
        cols = np.arange(shape[1], dtype=np.float32)[None, :]
        dist_map = np.zeros(shape, np.float32)
        for pos_i, pos in enumerate(pos_list_cropped):
            con = float(scores[pos_i])
            r, c = round(pos[0]), round(pos[1])
            dists = np.sqrt((rows - r) ** 2 + (cols - c) ** 2)
            dist_map += np.clip(con - con * dists * decay_rate, 0.0, 1.0)
        rng = dist_map.max() - dist_map.min()
        return (dist_map - dist_map.min()) / (rng if rng > 0 else 1.0)

    def get_distribution_map_3d(self, name: str, scores: np.ndarray,
                                pos_list_3d, decay_rate: float = 0.1
                                ) -> np.ndarray:
        """Per-voxel max of radially-decayed confidences from habitat-frame
        positions (reference :218-243; ground-plane distance in cells)."""
        scores = np.asarray(scores, np.float32)
        if scores.shape[0] > 1:
            rng = scores.max() - scores.min()
            scores = (scores - scores.min()) / (rng if rng > 0 else 1.0)
        grid_rc = self.map.grid_pos[:, :2].astype(np.float32)
        best = np.zeros(grid_rc.shape[0], np.float32)
        for con, pos in zip(scores, pos_list_3d):
            tf = np.eye(4)
            tf[:3, 3] = pos
            self.vlmaps_dataloader.from_habitat_tf(tf)
            row, col, _ = self.vlmaps_dataloader.to_full_map_pose()
            d = np.linalg.norm(grid_rc - np.array([row, col], np.float32),
                               axis=1)
            best = np.maximum(best, np.clip(con - decay_rate * d, 0.0, 1.0))
        return best

    def get_vl_distribution_map_3d(self, name: str,
                                   decay_rate: float = 0.1) -> np.ndarray:
        """Open-vocab object heatmap over voxels (reference :255-265 —
        min-distance decay from the category mask, on the TPU kernel)."""
        predict = np.argmax(self.map.scores_mat, axis=1)
        cat = find_similar_category_id(name, self.map.categories)
        mask = predict == cat
        # metric positions: distances in cells after the /cs division
        return heatmap_from_mask_3d(self.global_pc, mask, cell_size=self.cs,
                                    decay_rate=decay_rate,
                                    device=self.device)

    def get_vl_distribution_map(self, name: str,
                                decay_rate: float = 0.1) -> np.ndarray:
        """2D variant over the cropped map (reference :245-253)."""
        from avlmaps_torch.ops.pooling import pool_3d_label_to_2d
        from avlmaps_torch.ops.heatmap import heatmap_from_mask_2d

        mask3 = self.map.index_map(name, with_init_cat=True)
        mask2 = pool_3d_label_to_2d(mask3, self.map.grid_pos, self.gs)
        mask2 = mask2[self.vlmaps_dataloader.rmin:
                      self.vlmaps_dataloader.rmax + 1,
                      self.vlmaps_dataloader.cmin:
                      self.vlmaps_dataloader.cmax + 1]
        # reference robot decays per raw pixel (habitat_lang_robot.py:245-253)
        # — no cell_size division, unlike visualize_utils' 2D heatmap
        heat = heatmap_from_mask_2d(mask2, cell_size=1.0,
                                    decay_rate=decay_rate,
                                    device=self.device)
        rng = heat.max() - heat.min()
        return (heat - heat.min()) / (rng if rng > 0 else 1.0)

    def get_sound_distribution_map(self, name: str,
                                   decay_rate: float = 0.1) -> np.ndarray:
        probs, locations = self.sound_map.get_distribution_and_locations(
            name)
        reps = [locs[len(locs) // 2] if len(locs) else np.zeros(3)
                for locs in locations]
        return self.get_distribution_map(
            name, probs, self._positions_to_cropped(reps), decay_rate)

    def get_sound_distribution_map_3d(self, name: str,
                                      decay_rate: float = 0.05) -> np.ndarray:
        probs, locations = self.sound_map.get_distribution_and_locations(
            name)
        reps = [locs[len(locs) // 2] if len(locs) else np.zeros(3)
                for locs in locations]
        return self.get_distribution_map_3d(name, probs, reps, decay_rate)

    def get_image_distribution_map_3d(self, img: np.ndarray,
                                      query_intr_mat=None,
                                      decay_rate: float = 0.05) -> np.ndarray:
        _, base_tf = self.visual_map.localize_image(
            img, query_cam_intrinsic_mat=query_intr_mat)
        return self.get_distribution_map_3d("image", np.ones(1),
                                            [base_tf[:3, 3]], decay_rate)

    # -- region (area) maps (reference :267-355) ----------------------------

    area_map_type: str = "clip_sparse"  # "clip_sparse" | "gt"

    def load_area_map(self, data_dir: str, area_map=None) -> None:
        """Attach an AreaMap for region queries (clip_sparse variant)."""
        if area_map is None:
            from avlmaps_torch.map.area_map import AreaMap

            area_map = AreaMap(data_dir, device=self.device)
            area_map.load_map(data_dir)
        self.area_map = area_map

    def load_gt_region_map(self, region_gt: Dict[str, List[Dict]]) -> None:
        """Rasterise GT region boxes onto the cropped map
        (reference :157-181): region_gt maps category -> list of boxes with
        'region_center'/'region_size' in habitat coords."""
        import cv2

        obst = self.vlmaps_dataloader.get_obstacles_cropped()
        self.region_categories = sorted(region_gt.keys())
        self.gt_region_map = np.zeros(
            (len(self.region_categories), obst.shape[0], obst.shape[1]),
            np.uint8)
        for cat_i, cat in enumerate(self.region_categories):
            for box in region_gt[cat]:
                center = np.asarray(box["region_center"], np.float64)
                size = np.asarray(box["region_size"], np.float64)
                corners = []
                for corner in (center - size / 2, center + size / 2):
                    tf = np.eye(4)
                    tf[:3, 3] = corner
                    self.vlmaps_dataloader.from_habitat_tf(tf)
                    row, col, _ = self.vlmaps_dataloader.to_cropped_map_pose()
                    corners.append((int(col), int(row)))
                cv2.rectangle(self.gt_region_map[cat_i], corners[0],
                              corners[1], 1, -1)

    def get_region_distribution_map(self, name: str,
                                    decay_rate: float = 0.1) -> np.ndarray:
        """(reference :271-279)."""
        if self.area_map_type == "clip_sparse":
            return self.get_clip_sparse_region_distribution_map(name,
                                                                decay_rate)
        if self.area_map_type == "gt":
            return self.get_gt_region_map(name, decay_rate)
        raise ValueError(f"unknown area_map_type {self.area_map_type!r}")

    def get_clip_sparse_region_distribution_map(
            self, name: str, decay_rate: float = 0.1) -> np.ndarray:
        """Per-pose CLIP area scores splatted on the cropped map and
        MAX-combined, skipping out-of-crop poses
        (reference :325-355: dist_map = max(dist_map, clip(s - d*decay)))."""
        assert getattr(self, "area_map", None) is not None, \
            "Area map is not initialized. Call load_area_map() first."
        scores = np.asarray(
            self.area_map.index_map(name, with_init_cat=False), np.float32)
        rng_ = scores.max() - scores.min()
        scores = (scores - scores.min()) / (rng_ if rng_ > 0 else 1.0)
        shape = self.map.get_obstacle_cropped().shape
        rows = np.arange(shape[0], dtype=np.float32)[:, None]
        cols = np.arange(shape[1], dtype=np.float32)[None, :]
        dist_map = np.zeros(shape, np.float32)
        for i, tf_hab in enumerate(self.area_map.robot_pose_list):
            self.vlmaps_dataloader.from_habitat_tf(np.asarray(tf_hab))
            row, col, _ = self.vlmaps_dataloader.to_cropped_map_pose()
            if not (0 <= row < shape[0] and 0 <= col < shape[1]):
                continue
            s_i = float(scores[i])
            d = np.sqrt((rows - row) ** 2 + (cols - col) ** 2)
            dist_map = np.maximum(dist_map,
                                  np.clip(s_i - d * decay_rate, 0.0, 1.0))
        rng_ = dist_map.max() - dist_map.min()
        return (dist_map - dist_map.min()) / (rng_ if rng_ > 0 else 1.0)

    def get_gt_region_map(self, name: str,
                          decay_rate: float = 0.1) -> np.ndarray:
        """EDT decay from the named GT region mask (reference :283-298)."""
        from avlmaps_torch.ops.heatmap import heatmap_from_mask_2d

        assert getattr(self, "gt_region_map", None) is not None, \
            "GT region map is not initialized. Call load_gt_region_map()."
        cat = find_similar_category_id(name, self.region_categories)
        mask = self.gt_region_map[cat]
        heat = heatmap_from_mask_2d(mask, cell_size=1.0,
                                    decay_rate=decay_rate,
                                    device=self.device)
        rng = heat.max() - heat.min()
        return (heat - heat.min()) / (rng if rng > 0 else 1.0)

    # -- fusion entry points (reference :357-399) ---------------------------

    def get_map(self, obj: str = None, sound: str = None):
        assert obj is not None or sound is not None
        if obj is not None:
            return self.get_vl_distribution_map(obj, decay_rate=0.01)
        return self.get_sound_distribution_map(sound, decay_rate=0.01)

    def get_major_map(self, obj: str = None, sound: str = None):
        assert obj is not None or sound is not None
        if obj is not None:
            return self.get_vl_distribution_map(obj, decay_rate=0.1)
        return self.get_sound_distribution_map(sound, decay_rate=0.1)

    def get_map_3d(self, obj: str = None, sound: str = None,
                   img: np.ndarray = None, intr_mat=None):
        assert obj is not None or sound is not None or img is not None
        if obj is not None:
            return self.get_vl_distribution_map_3d(obj, decay_rate=0.03)
        if sound is not None:
            return self.get_sound_distribution_map_3d(sound, decay_rate=0.05)
        return self.get_image_distribution_map_3d(img, intr_mat,
                                                  decay_rate=0.05)

    def get_major_map_3d(self, obj: str = None, sound: str = None,
                         img: np.ndarray = None, intr_mat=None):
        assert obj is not None or sound is not None or img is not None
        if obj is not None:
            return self.get_vl_distribution_map_3d(obj, decay_rate=0.1)
        if sound is not None:
            return self.get_sound_distribution_map_3d(sound, decay_rate=0.05)
        return self.get_image_distribution_map_3d(img, intr_mat,
                                                  decay_rate=0.01)

    # -- goal selection (reference :419-430) --------------------------------

    def get_max_pos(self, map2d: np.ndarray) -> Tuple[float, float]:
        row, col = np.unravel_index(int(np.argmax(map2d)), map2d.shape)
        return (row + self.vlmaps_dataloader.rmin,
                col + self.vlmaps_dataloader.cmin)

    def get_max_pos_3d(self, heat: np.ndarray) -> Tuple[float, float, float]:
        return self.map.grid_pos[int(np.argmax(heat))]

    def get_max_pos_3d_fused(self, *heats) -> Tuple[int, int, int]:
        """Cross-modal fusion + goal pick ON DEVICE: elementwise product of
        the per-modality heats, argmax, voxel-position gather — the host
        fetches 12 bytes instead of len(heats) x 4 MB (the reference
        composes get_map_3d x get_major_map_3d on host numpy then
        get_max_pos_3d, habitat_lang_robot.py:357-430).  Accepts device
        heats straight from the ``delivery="device"`` query paths; matches
        the host product-argmax exactly (ties break to the first voxel).
        Host heats go to the robot's device (pinned, asynchronous) and the
        voxel positions are uploaded once a scene, so nothing before the
        12-byte fetch waits for the card."""
        from avlmaps_torch.ops.delivery import fetch_np, fused_goal_pick

        if self._grid_pos_dev is None:
            self._grid_pos_dev = to_device(self.map.grid_pos, self.device,
                                           non_blocking=True)
        heats = [h if isinstance(h, torch.Tensor)
                 else to_device(h, self.device, torch.float32,
                                non_blocking=True) for h in heats]
        pos, _ = fused_goal_pick(heats, self._grid_pos_dev)
        return tuple(int(v) for v in fetch_np(pos))
