"""The sparse voxel feature map artifact.

This is the central data structure tying map construction to indexing
(reference schema: avlmaps/utils/mapping_utils.py:469-541):

  grid_feat     (N, D) float32   fused pixel-embedding per occupied voxel
  grid_pos      (N, 3) int32     (row, col, height) of each occupied voxel
  weight        (N,)   float32   accumulated confidence
  occupied_ids  (gs, gs, vh) int32  dense voxel -> slot index (-1 = empty)
  grid_rgb      (N, 3) uint8/float  fused colour
  mapped_iter_list                 processed frame ids (resume support)

On-disk form is HDF5 with the reference's dataset names, so maps produced by
either implementation are interchangeable.  The port reads and writes it
with its own small codec (map/hdf5.py) on every host.

Device runtime form (used by the builder): the same arrays with a *fixed*
capacity N_max and weighted-sum storage (sum_w_feat, sum_w) instead of the
running mean — the associative reformulation of the reference's sequential
update (vlmap_builder.py:161-178): store Σ(w·f) and Σw, normalise on read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional, Sequence, Set, Union

import numpy as np

from avlmaps_torch.map import hdf5


# ---------------------------------------------------------------------------
# HDF5 serialization (byte-compatible with the reference schema)
# ---------------------------------------------------------------------------


def save_3d_map(save_path: Union[str, Path], grid_feat: np.ndarray,
                grid_pos: np.ndarray, weight: np.ndarray,
                occupied_ids: np.ndarray, mapped_iter_list: Iterable[int],
                grid_rgb: Optional[np.ndarray] = None) -> None:
    """Write the reference HDF5 schema (mapping_utils.py:469-506) with the
    built-in writer (map/hdf5.py)."""
    datasets = {
        "mapped_iter_list": np.array(sorted(mapped_iter_list),
                                     dtype=np.int32),
        "grid_feat": grid_feat, "grid_pos": grid_pos, "weight": weight,
        "occupied_ids": occupied_ids,
    }
    if grid_rgb is not None:
        datasets["grid_rgb"] = grid_rgb
    hdf5.write(save_path, datasets)


def load_3d_map(map_path: Union[str, Path]):
    """Read the reference HDF5 schema (mapping_utils.py:509-541).

    Returns (mapped_iter_list, grid_feat, grid_pos, weight, occupied_ids,
    grid_rgb).
    """
    f = hdf5.read(map_path)
    return (f["mapped_iter_list"].tolist(), f["grid_feat"], f["grid_pos"],
            f["weight"], f["occupied_ids"], f.get("grid_rgb"))


def save_clip_sparse_map(save_path: Union[str, Path],
                         clip_sparse_map: np.ndarray,
                         robot_pose_list: Sequence[np.ndarray]) -> None:
    """AreaMap artifact (reference mapping_utils.py:637-641):
    ``clip_sparse_map`` (N, D) and ``robot_pose_list`` (N, 4, 4)."""
    hdf5.write(save_path, {"clip_sparse_map": np.asarray(clip_sparse_map),
                           "robot_pose_list": np.asarray(robot_pose_list)})


def load_clip_sparse_map(load_path: Union[str, Path]):
    """(clip_sparse_map, robot_pose_list) of an AreaMap artifact."""
    f = hdf5.read(load_path)
    return f["clip_sparse_map"], f["robot_pose_list"]


# ---------------------------------------------------------------------------
# runtime artifact
# ---------------------------------------------------------------------------


@dataclass
class SparseVoxelMap:
    """In-memory sparse voxel feature map (host-side, numpy).

    ``grid_feat`` holds *normalised* (weighted-mean) features, matching the
    reference's storage; the builder converts from its weighted-sum device
    state when exporting (see avlmaps_torch/ops/voxel_fusion.py).
    """

    gs: int
    vh: int
    feat_dim: int
    grid_feat: np.ndarray  # (N, D) float32
    grid_pos: np.ndarray  # (N, 3) int32
    weight: np.ndarray  # (N,) float32
    occupied_ids: np.ndarray  # (gs, gs, vh) int32, -1 = empty
    grid_rgb: Optional[np.ndarray] = None  # (N, 3)
    mapped_iters: Set[int] = field(default_factory=set)

    @property
    def num_occupied(self) -> int:
        return int(self.grid_feat.shape[0])

    @classmethod
    def empty(cls, gs: int, vh: int, feat_dim: int) -> "SparseVoxelMap":
        return cls(
            gs=gs, vh=vh, feat_dim=feat_dim,
            grid_feat=np.zeros((0, feat_dim), np.float32),
            grid_pos=np.zeros((0, 3), np.int32),
            weight=np.zeros((0,), np.float32),
            occupied_ids=-np.ones((gs, gs, vh), np.int32),
            grid_rgb=np.zeros((0, 3), np.uint8),
        )

    def save(self, path: Union[str, Path]) -> None:
        save_3d_map(path, self.grid_feat, self.grid_pos, self.weight,
                    self.occupied_ids, self.mapped_iters, self.grid_rgb)

    @classmethod
    def load(cls, path: Union[str, Path]) -> "SparseVoxelMap":
        (mapped_iter_list, grid_feat, grid_pos, weight, occupied_ids,
         grid_rgb) = load_3d_map(path)
        gs = occupied_ids.shape[0]
        vh = occupied_ids.shape[2]
        return cls(gs=gs, vh=vh, feat_dim=grid_feat.shape[1],
                   grid_feat=grid_feat, grid_pos=grid_pos, weight=weight,
                   occupied_ids=occupied_ids, grid_rgb=grid_rgb,
                   mapped_iters=set(int(i) for i in mapped_iter_list))

    # -- 2D projections -----------------------------------------------------

    def top_down_height(self) -> np.ndarray:
        """Per-(row, col) max occupied height, -1 where empty."""
        hmax = np.full((self.gs, self.gs), -1, np.int32)
        if self.num_occupied:
            np.maximum.at(hmax, (self.grid_pos[:, 0], self.grid_pos[:, 1]),
                          self.grid_pos[:, 2])
        return hmax

    def obstacle_map(self, h_min: float = 0.0, h_max: float = 1.5,
                     cs: float = 0.05) -> np.ndarray:
        """(gs, gs) uint8 map, 1 = free, 0 = occupied in [h_min, h_max]
        (reference Map.generate_obstacle_map, map/map.py:79-95: counts voxels
        with slot id > 0 in the height band -- the reference's ``> 0`` also
        skips slot 0, and so does this)."""
        heights = np.arange(self.vh) * cs
        band = (heights > h_min) & (heights < h_max)
        occ = (self.occupied_ids[..., band] > 0).sum(axis=2)
        return (occ == 0).astype(np.uint8)
