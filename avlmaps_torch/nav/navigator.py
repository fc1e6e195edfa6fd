"""Navigator: per-scene visibility-graph holder with full<->cropped shifts.

Counterpart of ``avlmaps_tpu/nav/navigator.py``; mirrors reference
avlmaps/navigator/navigator.py:7-65.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from avlmaps_torch.nav.visgraph import (VisGraph,
                                       build_visgraph_with_obs_map,
                                       plan_to_pos_v2)


class Navigator:
    def __init__(self):
        self.visgraph: VisGraph | None = None
        self.obs_map: np.ndarray | None = None
        self.rowmin = 0
        self.colmin = 0

    def build_visgraph(self, obstacle_map: np.ndarray, rowmin: float,
                       colmin: float, vis: bool = False) -> None:
        self.obs_map = obstacle_map
        self.visgraph = build_visgraph_with_obs_map(obstacle_map, vis=vis)
        self.rowmin = rowmin
        self.colmin = colmin

    def plan_to(self, start_full_map: Tuple[float, float],
                goal_full_map: Tuple[float, float],
                vis: bool = False) -> List[List[float]]:
        """Full-map (row, col) start/goal -> full-map waypoint path
        (reference navigator.py:17-30)."""
        start = self._to_cropped(start_full_map)
        goal = self._to_cropped(goal_full_map)
        if self._start_in_graph_obstacle(start):
            self._rebuild_visgraph(start, vis)
        paths = plan_to_pos_v2(start, goal, self.obs_map, self.visgraph, vis)
        return self.shift_path(paths, self.rowmin, self.colmin)

    def shift_path(self, paths, row_shift: int, col_shift: int):
        return [[p[0] + row_shift, p[1] + col_shift] for p in paths]

    def _start_in_graph_obstacle(self, start) -> bool:
        return bool(self.obs_map[int(start[0]), int(start[1])] == 0)

    def _rebuild_visgraph(self, start, vis: bool = False) -> None:
        """Re-include internal contours when the start is enclosed
        (reference navigator.py:45-48)."""
        self.visgraph = build_visgraph_with_obs_map(
            self.obs_map, use_internal_contour=True, internal_point=start,
            vis=vis)

    def _to_cropped(self, full_map_pos):
        return [full_map_pos[0] - self.rowmin, full_map_pos[1] - self.colmin]

    def _to_full(self, cropped_pos):
        return [cropped_pos[0] + self.rowmin, cropped_pos[1] + self.colmin]
