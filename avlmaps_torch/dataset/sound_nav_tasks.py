"""Sound-navigation task generation.

Counterpart of ``dataset/sound_nav_tasks.py`` over the port's modules
(reference: avlmaps/utils/sound_nav_collect_utils.py) — load GT sound
categories + pose tracks per sequence, sample navigation start poses on free
space, pick distance-filtered goal sequences, and write task JSONs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence, Set, Tuple

import numpy as np

from avlmaps_torch.dataloader.habitat_dataloader import \
    VLMapsDataloaderHabitat
from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.utils.audio import setup_audio_paths


def load_audio_video_gt_cat_and_poses(seq_dir: Path,
                                      vlmaps_dataloader:
                                      VLMapsDataloaderHabitat,
                                      difficulty_level: str = "level_3"
                                      ) -> Tuple[List[str],
                                                 List[List[Tuple[int, int]]]]:
    """GT sound categories and their cropped-map pose tracks for one
    sequence (reference sound_nav_collect_utils.py:18-71), from the
    range_and_audio meta written at dataset generation."""
    meta = seq_dir / f"range_and_audio_meta_{difficulty_level}.txt"
    if not meta.exists():
        return [], []
    poses = np.loadtxt(seq_dir / "poses.txt")
    if poses.ndim == 1:
        poses = poses[None]
    categories: List[str] = []
    map_pose_lists: List[List[Tuple[int, int]]] = []
    for line in meta.read_text().splitlines():
        parts = line.strip().split(",")
        if len(parts) < 4:
            continue
        s_frame, e_frame = int(parts[0]), int(parts[1])
        cat = parts[-1]
        track = []
        for vec in poses[s_frame:e_frame]:
            vlmaps_dataloader.from_habitat_tf(pose_vec_to_tf(vec))
            row, col, _ = vlmaps_dataloader.to_cropped_map_pose()
            track.append((int(row), int(col)))
        categories.append(cat)
        map_pose_lists.append(track)
    return categories, map_pose_lists


def auto_generate_start_poses(vlmaps_dataloader: VLMapsDataloaderHabitat,
                              goal_pos_lists: Sequence[Sequence],
                              poses_num: int = 100,
                              radius_pix: int = 20,
                              seed: int = 0
                              ) -> List[Tuple[int, int, float]]:
    """Sample free-space full-map start poses near the goal tracks
    (reference :164-190)."""
    import cv2

    rng = np.random.default_rng(seed)
    free = vlmaps_dataloader.obstacles_cropped == 1
    mask = np.zeros_like(free, np.uint8)
    for pos_list in goal_pos_lists:
        for (row, col) in pos_list:
            cv2.circle(mask, (int(col), int(row)), radius_pix, 255, -1)
    mask = (mask > 0) & free
    rows, cols = np.where(mask)
    if rows.size == 0:
        rows, cols = np.where(free)
    ids = rng.integers(0, rows.size, poses_num)
    degs = rng.uniform(-180, 180, poses_num)
    return [(int(rows[i]) + vlmaps_dataloader.rmin,
             int(cols[i]) + vlmaps_dataloader.cmin, float(d))
            for i, d in zip(ids, degs)]


def filter_goals_with_distance(start_pos, goal_positions,
                               dist_range: Tuple[float, float]
                               ) -> np.ndarray:
    """(reference :192-202)."""
    start = np.asarray(start_pos, np.float64)
    min_dists = np.array([
        np.min(np.linalg.norm(np.asarray(goals, np.float64) - start,
                              axis=-1)) if len(goals) else np.inf
        for goals in goal_positions])
    return np.where((min_dists > dist_range[0])
                    & (min_dists < dist_range[1]))[0]


def select_goal_sequence(start_pos, candidate_positions,
                         n_goals: int = 2,
                         dist_range_pix: Tuple[float, float] = (20, 100),
                         ) -> List[int]:
    """Greedy goal chain: each next goal within the distance band of the
    previous one, widening the band until found (reference :230-279)."""
    assigned: Set[int] = set()
    chain: List[int] = []
    curr = np.asarray(start_pos, np.float64)
    for _ in range(n_goals):
        band = list(dist_range_pix)
        ids: List[int] = []
        while not ids:
            ids = [i for i in filter_goals_with_distance(
                curr, candidate_positions, tuple(band))
                if i not in assigned]
            band[1] += 10
            if band[1] > 1000:
                break
        if not ids:
            break
        pick = int(ids[0])
        chain.append(pick)
        assigned.add(pick)
        goals = np.asarray(candidate_positions[pick], np.float64)
        curr = goals[np.argmin(np.linalg.norm(goals - curr, axis=-1))]
    return chain


def write_sound_nav_tasks(data_dir, vlmaps_dataloader,
                          difficulty_level: str = "level_3",
                          tasks_per_scene: int = 20,
                          goals_per_task: int = 2, seed: int = 0) -> Path:
    """Generate spatial_goal_navigation_tasks.json for a scene
    (reference task writers :281-319)."""
    _, seq_dirs = setup_audio_paths(data_dir)
    categories: List[str] = []
    tracks: List[List[Tuple[int, int]]] = []
    for seq_dir in seq_dirs:
        cats, pose_lists = load_audio_video_gt_cat_and_poses(
            seq_dir, vlmaps_dataloader, difficulty_level)
        categories.extend(cats)
        tracks.extend(pose_lists)

    full_tracks = [[(r + vlmaps_dataloader.rmin, c + vlmaps_dataloader.cmin)
                    for (r, c) in t] for t in tracks]
    starts = auto_generate_start_poses(vlmaps_dataloader, tracks,
                                       poses_num=tasks_per_scene, seed=seed)
    tasks = []
    for task_id, (row, col, deg) in enumerate(starts):
        chain = select_goal_sequence((row, col), full_tracks,
                                     n_goals=goals_per_task)
        if not chain:
            continue
        vlmaps_dataloader.from_full_map_pose(row, col, deg)
        tasks.append({
            "task_id": len(tasks),
            "tf_habitat":
                vlmaps_dataloader.to_habitat_tf().reshape(-1).tolist(),
            "instruction": " then ".join(
                f"go to the {categories[i]} sound" for i in chain),
            "sound_categories": [categories[i] for i in chain],
            "goals": [[list(map(int, p)) for p in full_tracks[i]]
                      for i in chain],
        })
    out = Path(data_dir) / "spatial_goal_navigation_tasks.json"
    out.write_text(json.dumps(tasks, indent=2))
    return out
