"""Map base class: obstacle maps, cropping, and 2D spatial reasoning.

Counterpart of ``avlmaps_tpu/map/map_base.py``: host-side logic mirroring
the reference's avlmaps/map/map.py (obstacle generation :79-104, dilate
:169-181, spatial relations :183-485).  It runs on small (gs x gs) arrays
and OpenCV contours, so it stays on the host (numpy, cv2, and the port's
morphology on CPU tensors); the shapely dependency is replaced by a direct
nearest-point-on-polygon computation.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

import torch

from avlmaps_torch.config import MapConfig
from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                               build_base_transform)
from avlmaps_torch.ops.morphology import binary_dilation, gaussian_blur


def get_segment_islands_pos(segment_map, label_id,
                            detect_internal_contours: bool = False):
    """Connected components of a label mask -> (contours [np (N,2) row,col],
    centers, bboxes [rmin,rmax,cmin,cmax], hierarchy)
    (reference index_utils.py:35-61)."""
    mask = (segment_map == label_id).astype(np.uint8)
    mode = cv2.RETR_TREE if detect_internal_contours else cv2.RETR_EXTERNAL
    contours, hierarchy = cv2.findContours(mask, mode,
                                           cv2.CHAIN_APPROX_SIMPLE)
    contours_list, centers_list, bbox_list = [], [], []
    for contour in contours:
        c = contour.reshape(-1, 2)[:, ::-1]  # cv2 (x,y) -> (row,col)
        contours_list.append(c)
        rmin, rmax = int(c[:, 0].min()), int(c[:, 0].max())
        cmin, cmax = int(c[:, 1].min()), int(c[:, 1].max())
        bbox_list.append([rmin, rmax, cmin, cmax])
        centers_list.append([(rmin + rmax) / 2, (cmin + cmax) / 2])
    return contours_list, centers_list, bbox_list, hierarchy


def get_dist_to_bbox_2d(center, size, pos) -> float:
    """Distance from pos to an axis-aligned box (0 inside)
    (reference navigation_utils.py:209-266)."""
    dx = pos[0] - center[0]
    dy = pos[1] - center[1]
    ox = abs(dx) - size[0] / 2
    oy = abs(dy) - size[1] / 2
    if ox > 0 and oy > 0:
        return float(np.sqrt(ox * ox + oy * oy))
    if ox > 0:
        return float(ox)
    if oy > 0:
        return float(oy)
    return 0.0


def nearest_point_on_polygon(coord, polygon) -> List[int]:
    """Closest point on the polygon boundary to coord (reference uses
    shapely's exterior.project/interpolate, map.py:195-208; here computed
    directly per edge segment)."""
    p = np.asarray(coord, np.float64)
    poly = np.asarray(polygon, np.float64)
    best, best_d = poly[0], np.inf
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        ab = b - a
        denom = float(ab @ ab)
        t = 0.0 if denom == 0 else float(np.clip((p - a) @ ab / denom, 0, 1))
        q = a + t * ab
        d = float(np.sum((p - q) ** 2))
        if d < best_d:
            best, best_d = q, d
    return [int(best[0]), int(best[1])]


class Map:
    """Abstract map: voxel artifact access + top-down spatial reasoning."""

    def __init__(self, map_config: MapConfig, data_dir: str = ""):
        self.map_config = map_config
        self.gs = map_config.grid_size
        self.cs = map_config.cell_size

        self.mapped_iter_list = None
        self.grid_feat: Optional[np.ndarray] = None
        self.grid_pos: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.occupied_ids: Optional[np.ndarray] = None
        self.grid_rgb: Optional[np.ndarray] = None

        self.obstacles_map: Optional[np.ndarray] = None
        self.obstacles_cropped: Optional[np.ndarray] = None
        self.obstacles_new_cropped: Optional[np.ndarray] = None
        self.rmin = self.rmax = self.cmin = self.cmax = 0

        self._setup_transforms()
        if data_dir:
            self._setup_paths(data_dir)

    # -- setup --------------------------------------------------------------

    def _setup_paths(self, data_dir: Union[Path, str]) -> None:
        """Scene directory layout (reference map.py:40-52)."""
        self.data_dir = Path(data_dir)
        self.rgb_dir = self.data_dir / "rgb"
        self.depth_dir = self.data_dir / "depth"
        self.semantic_dir = self.data_dir / "semantic"
        self.pose_path = self.data_dir / "poses.txt"
        self.rgb_paths = sorted(self.rgb_dir.glob("*.png"))
        self.depth_paths = sorted(self.depth_dir.glob("*.npy"))
        self.semantic_paths = sorted(self.semantic_dir.glob("*.npy"))

    def _setup_transforms(self):
        """base->camera and canonical base-axes transforms from config
        (reference map.py:54-68)."""
        pi = self.map_config.pose_info
        self.base2cam_tf = build_base2cam_tf(pi.base2cam_rot,
                                             pi.camera_height)
        self.base_transform = build_base_transform(pi.base_forward_axis,
                                                   pi.base_left_axis,
                                                   pi.base_up_axis)
        return self.base2cam_tf, self.base_transform

    # -- abstract -----------------------------------------------------------

    def create_map(self, data_dir):
        raise NotImplementedError

    def load_map(self, data_dir) -> bool:
        raise NotImplementedError

    def index_map(self, language_desc: str, with_init_cat: bool = True):
        raise NotImplementedError

    def init_categories(self, categories: List[str]):
        raise NotImplementedError

    def get_pos(self, name: str):
        raise NotImplementedError

    @staticmethod
    def create(map_config: MapConfig) -> "Map":
        """Factory (reference map.py:121-144)."""
        from avlmaps_torch.map.vlmap import VLMap

        if map_config.map_type in ("vlmap", "vlmap_openmap"):
            return VLMap(map_config)
        raise ValueError(f"unknown map_type {map_config.map_type!r}")

    # -- obstacle maps ------------------------------------------------------

    def generate_obstacle_map(self, h_min: float = 0,
                              h_max: float = 1.5) -> np.ndarray:
        """(gs, gs): 1 free, 0 occupied (reference map.py:79-95, including
        its ``> 0`` slot check that skips slot id 0)."""
        assert self.occupied_ids is not None, "map not loaded"
        heights = np.arange(self.occupied_ids.shape[-1]) * self.cs
        band = (heights > h_min) & (heights < h_max)
        occ = (self.occupied_ids[..., band] > 0).sum(axis=2)
        self.obstacles_map = (occ == 0).astype(np.uint8)
        self.generate_cropped_obstacle_map(self.obstacles_map)
        return self.obstacles_map

    def generate_cropped_obstacle_map(self, obstacle_map) -> np.ndarray:
        x_idx, y_idx = np.where(obstacle_map == 0)
        if x_idx.size == 0:
            # no obstacles in the height band (sparse/degenerate scene):
            # crop to the full grid instead of crashing (the reference
            # would raise on .min() of an empty index set, map.py:97-101)
            x_idx = np.arange(obstacle_map.shape[0])
            y_idx = np.arange(obstacle_map.shape[1])
        self.rmin, self.rmax = int(x_idx.min()), int(x_idx.max())
        self.cmin, self.cmax = int(y_idx.min()), int(y_idx.max())
        self.obstacles_cropped = obstacle_map[self.rmin:self.rmax + 1,
                                              self.cmin:self.cmax + 1]
        return self.obstacles_cropped

    def generate_rgb_topdown_map(self) -> np.ndarray:
        from avlmaps_torch.ops.pooling import pool_3d_rgb_to_2d

        assert self.grid_rgb is not None and self.grid_pos is not None
        return pool_3d_rgb_to_2d(self.grid_rgb, self.grid_pos, self.gs)

    def get_obstacle_cropped(self):
        return self.obstacles_cropped

    def get_customized_obstacle_cropped(self):
        return self.obstacles_new_cropped

    def get_rgb_topdown_map_cropped(self) -> np.ndarray:
        rgb_map = self.generate_rgb_topdown_map()
        return rgb_map[self.rmin:self.rmax, self.cmin:self.cmax]

    @staticmethod
    def _dilate_map(binary_map: np.ndarray, dilate_iter: int = 0,
                    gaussian_sigma: float = 1.0) -> np.ndarray:
        """2x upsample -> gaussian -> threshold -> dilate -> downsample
        (reference map.py:169-181)."""
        h, w = binary_map.shape
        up = cv2.resize(binary_map.astype(float), (w * 2, h * 2))
        sm = gaussian_blur(torch.from_numpy(up), sigma=gaussian_sigma,
                           truncate=3.0).numpy()
        th = (sm > 0.5).astype(np.uint8)
        if dilate_iter > 0:
            th = binary_dilation(torch.from_numpy(th.astype(bool)),
                                 iterations=dilate_iter * 2).numpy().astype(
                np.uint8)
        return cv2.resize(th.astype(float), (w, h))

    # -- spatial reasoning (reference map.py:183-485) -----------------------

    def get_nearest_pos(self, curr_pos, name: str) -> List[float]:
        contours, centers, bbox_list = self.get_pos(name)
        ids = self.filter_small_objects(bbox_list, area_thres=10)
        contours = [contours[i] for i in ids]
        centers = [centers[i] for i in ids]
        bbox_list = [bbox_list[i] for i in ids]
        if not centers:
            return list(curr_pos)
        i = self.select_nearest_obj(centers, bbox_list, curr_pos)
        return nearest_point_on_polygon(curr_pos, contours[i])

    def get_forward_pos(self, curr_pos, curr_angle_deg: float,
                        meters: float) -> List[float]:
        i, j = curr_pos
        rad = np.deg2rad(curr_angle_deg)
        pix = meters / self.cs
        return [i - pix * np.cos(rad), j + pix * np.sin(rad)]

    def filter_small_objects(self, bbox_list, area_thres: int = 50):
        keep = []
        for bi, bbox in enumerate(bbox_list):
            area = (bbox[1] - bbox[0]) * (bbox[3] - bbox[2])
            if area > area_thres:
                keep.append(bi)
        return keep

    def select_nearest_obj(self, centers, bbox_list, curr_pos) -> int:
        dists = []
        for c, bbox in zip(centers, bbox_list):
            size = np.array([bbox[1] - bbox[0], bbox[3] - bbox[2]])
            dists.append(get_dist_to_bbox_2d(np.array(c), size,
                                             np.array(curr_pos)))
        return int(np.argmin(dists))

    def select_front_objs(self, centers, curr_pos, curr_angle_deg: float,
                          fov_deg: float = 90):
        """Objects inside the robot's forward FOV cone
        (reference map.py:308-349: up is angle 0, clockwise positive)."""
        theta = np.deg2rad(curr_angle_deg)
        fov_2 = np.deg2rad(fov_deg) / 2
        pi_2 = np.pi / 2
        row_org, col_org = curr_pos
        ids = []
        for ci, (row, col) in enumerate(centers):
            ang = np.arctan2(-col + col_org, -row + row_org)
            if (abs(ang - theta) < fov_2
                    or (theta > pi_2 and ang < -pi_2
                        and abs(2 * np.pi - theta + ang) < fov_2)
                    or (theta < -pi_2 and ang > pi_2
                        and abs(2 * np.pi - ang + theta) < fov_2)):
                ids.append(ci)
        return ids

    def get_front_nearest_obj_pos(self, curr_pos, curr_angle_deg, name):
        contours, centers, bbox_list = self.get_pos(name)
        ids = self.select_front_objs(centers, curr_pos, curr_angle_deg)
        if not ids:
            return None
        front_centers = [centers[i] for i in ids]
        nearest = self.select_nearest_obj(front_centers, bbox_list, curr_pos)
        return front_centers[nearest]

    def get_front_nearest_obj_pos_box(self, curr_pos, curr_angle_deg, name):
        contours, centers, bbox_list = self.get_pos(name)
        ids = self.select_front_objs(centers, curr_pos, curr_angle_deg)
        if not ids:
            return None, None
        front_centers = [centers[i] for i in ids]
        front_bboxes = [bbox_list[i] for i in ids]
        nearest = self.select_nearest_obj(front_centers, front_bboxes,
                                          curr_pos)
        return front_centers[nearest], front_bboxes[nearest]

    def _get_left_pos(self, curr_pos, tar_pos, tar_bbox):
        di = tar_pos[0] - curr_pos[0]
        dj = tar_pos[1] - curr_pos[1]
        angle = np.arctan2(-dj, -di)
        h = tar_bbox[1] - tar_bbox[0]
        w = tar_bbox[3] - tar_bbox[2]
        d = 0.5 * np.sqrt(h * h + w * w) + 2
        return [tar_pos[0] + np.sin(angle) * d,
                tar_pos[1] - np.cos(angle) * d]

    def _get_right_pos(self, curr_pos, tar_pos, tar_bbox):
        di = tar_pos[0] - curr_pos[0]
        dj = tar_pos[1] - curr_pos[1]
        angle = np.arctan2(-dj, -di)
        h = tar_bbox[1] - tar_bbox[0]
        w = tar_bbox[3] - tar_bbox[2]
        d = 0.5 * np.sqrt(h * h + w * w)
        return [tar_pos[0] - np.sin(angle) * d,
                tar_pos[1] + np.cos(angle) * d]

    def get_left_pos(self, curr_pos, curr_angle_deg, name):
        center, bbox = self.get_front_nearest_obj_pos_box(
            curr_pos, curr_angle_deg, name)
        if center is None:
            return [None, None]
        return self._get_left_pos(curr_pos, center, bbox)

    def get_right_pos(self, curr_pos, curr_angle_deg, name):
        center, bbox = self.get_front_nearest_obj_pos_box(
            curr_pos, curr_angle_deg, name)
        if center is None:
            return [None, None]
        return self._get_right_pos(curr_pos, center, bbox)

    def find_middle_between_contours(self, cona, conb):
        ca = np.asarray(cona, np.float64).reshape(-1, 1, 2)
        cb = np.asarray(conb, np.float64).reshape(1, -1, 2)
        dist = np.linalg.norm(ca - cb, axis=2)
        i, j = np.unravel_index(np.argmin(dist), dist.shape)
        return (np.asarray(cona[i], np.float64)
                + np.asarray(conb[j], np.float64)) / 2

    def get_pos_in_between(self, curr_pos, curr_angle_deg, obj_a_name,
                           obj_b_name):
        """Midpoint between the closest pair of front instances of two
        categories (reference map.py:366-413)."""
        contours_a, centers_a, bbox_a = self.get_pos(obj_a_name)
        contours_b, centers_b, bbox_b = self.get_pos(obj_b_name)
        ids_a = self.select_front_objs(centers_a, curr_pos, curr_angle_deg)
        ids_b = self.select_front_objs(centers_b, curr_pos, curr_angle_deg)
        if not ids_a or not ids_b:
            return None
        contours_a = [contours_a[i] for i in ids_a]
        contours_b = [contours_b[i] for i in ids_b]
        fb_a = [bbox_a[i] for i in ids_a]
        fb_b = [bbox_b[i] for i in ids_b]
        keep_a = self.filter_small_objects(fb_a)
        keep_b = self.filter_small_objects(fb_b)
        if not keep_a or not keep_b:
            return None
        front_centers_a = [centers_a[j] for j in ids_a]
        front_centers_b = [centers_b[j] for j in ids_b]
        ca = [x for i, x in enumerate(front_centers_a) if i in keep_a]
        cb = [x for i, x in enumerate(front_centers_b) if i in keep_b]
        cona = [x for i, x in enumerate(contours_a) if i in keep_a]
        conb = [x for i, x in enumerate(contours_b) if i in keep_b]
        ca_np = np.asarray(ca, np.float64).reshape(-1, 1, 2)
        cb_np = np.asarray(cb, np.float64).reshape(1, -1, 2)
        middle = (ca_np + cb_np) / 2
        to_curr = np.linalg.norm(
            middle - np.asarray(curr_pos, np.float64).reshape(1, 1, 2),
            axis=-1)
        i, j = np.unravel_index(np.argmin(to_curr), to_curr.shape)
        return self.find_middle_between_contours(cona[i], conb[j])

    def get_delta_angle_to(self, curr_pos, curr_angle_deg, name):
        contours, centers, bbox_list = self.get_pos(name)
        nearest = self.select_nearest_obj(centers, bbox_list, curr_pos)
        dx = centers[nearest][0] - curr_pos[0]
        dy = centers[nearest][1] - curr_pos[1]
        angle = np.degrees(np.arctan2(dy, -dx))
        turn_right = np.mod(angle - curr_angle_deg, 360)
        if turn_right > 180:
            turn_right -= 360
        elif turn_right < -180:
            turn_right += 360
        return turn_right

    def _get_cardinal(self, curr_pos, curr_angle_deg, name):
        return self.get_front_nearest_obj_pos_box(curr_pos, curr_angle_deg,
                                                  name)

    def get_north_pos(self, curr_pos, curr_angle_deg, name, dist: int = 10):
        center, box = self._get_cardinal(curr_pos, curr_angle_deg, name)
        if center is None:
            return ["stop"]
        return [box[0] - dist, center[1]]

    def get_south_pos(self, curr_pos, curr_angle_deg, name, dist: int = 10):
        center, box = self._get_cardinal(curr_pos, curr_angle_deg, name)
        if center is None:
            return ["stop"]
        return [box[1] + dist, center[1]]

    def get_west_pos(self, curr_pos, curr_angle_deg, name, dist: int = 10):
        center, box = self._get_cardinal(curr_pos, curr_angle_deg, name)
        if center is None:
            return ["stop"]
        return [center[0], box[2] - dist]

    def get_east_pos(self, curr_pos, curr_angle_deg, name, dist: int = 10):
        center, box = self._get_cardinal(curr_pos, curr_angle_deg, name)
        if center is None:
            return ["stop"]
        return [center[0], box[3] + dist]
