"""Interactive top-down map: pick poses/goals, convert clicks to simulator
states, overlay boxes and paths.

Counterpart of ``avlmaps_tpu/map/interactive_map.py``; reference:
avlmaps/map/interactive_map.py (matplotlib/TkAgg click UI).
Re-designed with a headless programmatic core — click positions are plain
(row, col) lists, so every conversion/visualisation path is testable — plus
an optional matplotlib click front-end.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.config import MapConfig
from avlmaps_torch.dataloader.habitat_dataloader import VLMapsDataloaderHabitat


class InteractiveMap:
    """With ``map=None`` the scene's VLMap is loaded on ``device``
    (default ``"cuda"``; raises without a card)."""

    def __init__(self, data_dir, map_config: MapConfig, map=None,
                 device: Union[str, torch.device] = "cuda"):
        self.data_dir = Path(data_dir)
        self.map_config = map_config
        self.vlmaps_dataloader = VLMapsDataloaderHabitat(
            data_dir, map_config, map=map, device=device)
        self.coords: List[Tuple[float, float]] = []

    # -- headless core ------------------------------------------------------

    def set_map_positions(self, coords_cropped: Sequence[Tuple[float, float]]
                          ) -> None:
        """Provide picked (row, col) positions on the cropped map
        programmatically (what the click UI produces)."""
        self.coords = [tuple(c) for c in coords_cropped]

    def get_habitat_robot_state(self, start: Tuple[float, float],
                                toward: Tuple[float, float]) -> np.ndarray:
        """Two picked points (position + facing direction) -> habitat tf
        (reference interactive_map.py:249-263)."""
        drow = toward[0] - start[0]
        dcol = toward[1] - start[1]
        # map heading: 0 deg points up (negative row), ccw positive
        theta_deg = np.degrees(np.arctan2(-dcol, -drow))
        self.vlmaps_dataloader.from_cropped_map_pose(start[0], start[1],
                                                     theta_deg)
        return self.vlmaps_dataloader.to_habitat_tf()

    def cropped_rgb_map(self) -> np.ndarray:
        dl = self.vlmaps_dataloader
        rgb = dl.map.generate_rgb_topdown_map()
        return rgb[dl.rmin:dl.rmax + 1, dl.cmin:dl.cmax + 1]

    def draw_path(self, canvas: np.ndarray,
                  path_cropped: Sequence[Sequence[float]],
                  color=(255, 0, 0)) -> np.ndarray:
        """Overlay a planned path (reference play_actions drawing)."""
        import cv2

        out = np.ascontiguousarray(canvas.copy())
        pts = [(int(p[1]), int(p[0])) for p in path_cropped]
        for a, b in zip(pts[:-1], pts[1:]):
            cv2.line(out, a, b, color, 1)
        for p in pts:
            cv2.circle(out, p, 2, color, -1)
        return out

    def draw_boxes(self, canvas: np.ndarray,
                   bboxes: Sequence[Sequence[float]],
                   color=(0, 255, 0)) -> np.ndarray:
        """Overlay (rmin, rmax, cmin, cmax) boxes (cropped coords)."""
        import cv2

        out = np.ascontiguousarray(canvas.copy())
        for (rmin, rmax, cmin, cmax) in bboxes:
            cv2.rectangle(out, (int(cmin), int(rmin)),
                          (int(cmax), int(rmax)), color, 1)
        return out

    def play_actions(self, sim, init_tf: np.ndarray,
                     actions: Sequence[str]) -> List[Tuple[float, float]]:
        """Replay actions in a simulator, returning the visited cropped-map
        positions (reference play_actions :494-511)."""
        sim.set_agent_tf(init_tf)
        visited = []
        for action in actions:
            if action != "stop":
                sim.step(action)
            self.vlmaps_dataloader.from_habitat_tf(sim.get_agent_tf())
            row, col, _ = self.vlmaps_dataloader.to_cropped_map_pose()
            visited.append((row, col))
        return visited

    # -- click UI -----------------------------------------------------------

    def collect_map_positions(self, background: Optional[np.ndarray] = None,
                              n_points: Optional[int] = None
                              ) -> List[Tuple[float, float]]:  # pragma: no cover - UI
        """Open a matplotlib window, record clicked (row, col) positions
        (reference collect_map_positions :120-188)."""
        import matplotlib.pyplot as plt

        if background is None:
            background = self.cropped_rgb_map()
        self.coords = []
        fig, ax = plt.subplots()
        ax.imshow(background)
        ax.set_title("click positions; close the window when done")

        def onclick(event):
            if event.xdata is None or event.ydata is None:
                return
            self.coords.append((float(event.ydata), float(event.xdata)))
            ax.plot(event.xdata, event.ydata, "r+")
            fig.canvas.draw_idle()
            if n_points is not None and len(self.coords) >= n_points:
                plt.close(fig)

        fig.canvas.mpl_connect("button_press_event", onclick)
        plt.show()
        return self.coords
