"""3D <-> 2D map pooling.

Counterpart of ``avlmaps_tpu/ops/pooling.py`` (reference loops:
avlmaps/utils/visualize_utils.py:77-94 and avlmaps/map/avlmap.py:100-144).
The two scatters run in torch on the input's device (host arrays on the
CPU); positions outside the (gs, gs) grid are dropped, as the JAX
package's ``mode="drop"`` does.  Results are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(a, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _scatter_max_2d(values: torch.Tensor, grid_pos, gs: int,
                    fill) -> np.ndarray:
    """Max of ``values`` per (row, col) cell of a (gs, gs) grid that
    starts at ``fill``; out-of-grid rows write to a spare cell.  Indices
    in [-gs, 0) count from the end, as the JAX package's ``.at[]`` reads
    them."""
    pos = _as_tensor(grid_pos, torch.int64).to(values.device)[:, :2]
    pos = torch.where(pos < 0, pos + gs, pos)
    inside = ((pos[:, 0] >= 0) & (pos[:, 0] < gs) & (pos[:, 1] >= 0)
              & (pos[:, 1] < gs))
    lin = torch.where(inside, pos[:, 0] * gs + pos[:, 1], gs * gs)
    out = torch.full((gs * gs + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, lin, values, "amax")
    return out[:-1].view(gs, gs).cpu().numpy()


def pool_3d_label_to_2d(mask_3d, grid_pos, gs: int) -> np.ndarray:
    """OR-pool voxel labels onto the top-down grid
    (reference pool_3d_label_to_2d, visualize_utils.py:77-83)."""
    return _scatter_max_2d(_as_tensor(mask_3d, torch.uint8), grid_pos, gs,
                           0).astype(bool)


def pool_3d_value_to_2d_max(values, grid_pos, gs: int) -> np.ndarray:
    """Max-pool per-voxel scalars onto the top-down grid (cells without a
    voxel, and cells whose voxels are all negative, hold 0)."""
    return _scatter_max_2d(_as_tensor(values, torch.float32), grid_pos, gs,
                           0.0)


def pool_3d_rgb_to_2d(rgb, grid_pos, gs: int) -> np.ndarray:
    """Top-down RGB: the colour of the highest voxel in each column.

    The reference (visualize_utils.py:86-94) intends this but never
    updates its height buffer, so it degrades to last-write-wins; this
    keeps the JAX package's intended highest-voxel semantics (host
    numpy)."""
    rgb = np.asarray(rgb)
    grid_pos = np.asarray(grid_pos, np.int64)
    # encode (height, slot) so np.maximum.at picks the highest voxel's slot
    n = grid_pos.shape[0]
    keys = grid_pos[:, 2] * (n + 1) + np.arange(n)
    best = np.full((gs, gs), -1, np.int64)
    np.maximum.at(best, (grid_pos[:, 0], grid_pos[:, 1]), keys)
    out = np.zeros((gs, gs, 3), rgb.dtype)
    hit = best >= 0
    out[hit] = rgb[best[hit] % (n + 1)]
    return out


def lift_2d_to_3d(heatmap_2d, grid_pos) -> np.ndarray:
    """Broadcast a (gs, gs) heatmap onto voxel slots by their (row, col)
    (reference avlmap.py:100-144, which loops over occupied_ids)."""
    heatmap_2d = np.asarray(heatmap_2d)
    grid_pos = np.asarray(grid_pos, np.int64)
    return heatmap_2d[grid_pos[:, 0], grid_pos[:, 1]].astype(np.float32)
