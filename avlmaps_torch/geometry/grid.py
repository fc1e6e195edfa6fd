"""World <-> voxel-grid converters: host scalars and arrays, and tensors.

Counterpart of ``avlmaps_tpu/geometry/grid.py`` (reference semantics:
avlmaps/utils/mapping_utils.py:318-376, 392-400).  The
reference's SCALAR converter truncates twice (``int(gs/2 - int(x/cs))``)
while its batch converter truncates once after the subtraction; the two
disagree for e.g. x/cs = 1.4.  The map-building hot loop uses the scalar
form (vlmap_builder.py:137), so :func:`base_pos_to_grid_id` reproduces the
double truncation, with ``torch.trunc`` wherever JAX uses ``jnp.trunc``.
The host converters keep the reference's names, save the scalar base->grid
form, :func:`base_pos_to_grid_id_scalar`: the tensor form holds the name.
"""

from __future__ import annotations

import numpy as np
import torch


# -- 2D converters (top-down maps; reference mapping_utils.py:318-330) -----


def pos_to_grid_id_2d(gs: int, cs: float, xx: float, yy: float):
    x = int(gs / 2 + int(xx / cs))
    y = int(gs / 2 - int(yy / cs))
    return [x, y]


def grid_id_to_pos_2d(gs: int, cs: float, x: int, y: int):
    xx = (x - gs / 2) * cs
    zz = (gs / 2 - y) * cs
    return xx, zz


# -- 3D base-frame converters on the host ----------------------------------


def base_pos_to_grid_id_scalar(gs: int, cs: float, x: float, y: float,
                               z: float):
    """Scalar (row, col, h), truncating twice: ``avlmaps_tpu``'s
    ``base_pos_to_grid_id`` (grid.py:42-48), the reference's
    base_pos2grid_id_3d (mapping_utils.py:345-350)."""
    row = int(gs / 2 - int(x / cs))
    col = int(gs / 2 - int(y / cs))
    h = int(z / cs)
    return [row, col, h]


def base_pos_to_grid_id_batch(gs: int, cs: float,
                              pos: np.ndarray) -> np.ndarray:
    """(N, 3) positions -> (N, 3) int32 grid ids, truncating once after the
    subtraction (reference mapping_utils.py:352-359)."""
    row = (gs / 2 - pos[:, 0] / cs).astype(np.int32)
    col = (gs / 2 - pos[:, 1] / cs).astype(np.int32)
    h = (pos[:, 2] / cs).astype(np.int32)
    return np.stack([row, col, h], axis=1)


def grid_id_to_base_pos(row: int, col: int, height: int, cs: float, gs: int):
    """Scalar inverse (reference grid_id2base_pos_3d,
    mapping_utils.py:362-366)."""
    return [(gs / 2 - row) * cs, (gs / 2 - col) * cs, height * cs]


def grid_id_to_base_pos_batch(pos_grid: np.ndarray, cs: float,
                              gs: int) -> np.ndarray:
    """(N, 3) int grid ids -> (N, 3) float positions (reference
    grid_id2base_pos_3d_batch, mapping_utils.py:369-376)."""
    base_x = (gs / 2 - pos_grid[:, 0]) * cs
    base_y = (gs / 2 - pos_grid[:, 1]) * cs
    base_z = pos_grid[:, 2] * cs
    return np.stack([base_x, base_y, base_z], axis=1)


def grid_id_to_cam_pos_batch(pos_grid: np.ndarray, camera_height: float,
                             cs: float, gs: int) -> np.ndarray:
    """(N, 3) grid ids -> camera-convention positions (x right, y up, z
    back) (reference grid_id2pos_3d_batch, mapping_utils.py:392-400)."""
    cam_x = (pos_grid[:, 1] - gs / 2) * cs
    cam_z = (gs / 2 - pos_grid[:, 0]) * cs
    cam_y = camera_height - pos_grid[:, 2] * cs
    return np.stack([cam_x, cam_y, cam_z], axis=1)


# -- tensor twins for the voxel fusion -------------------------------------


def base_pos_to_grid_id(gs: int, cs: float, pos: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 base-frame positions -> (..., 3) int32 (row, col, h)."""
    row = torch.trunc(gs / 2 - torch.trunc(pos[..., 0] / cs))
    col = torch.trunc(gs / 2 - torch.trunc(pos[..., 1] / cs))
    h = torch.trunc(pos[..., 2] / cs)
    return torch.stack([row, col, h], dim=-1).to(torch.int32)


def out_of_range_mask(grid_ids: torch.Tensor, gs: int, vh: int) -> torch.Tensor:
    """True for ids inside the (gs, gs, vh) grid (the negation of the
    reference's ``_out_of_range``, vlmap_builder.py:283-284)."""
    row, col, h = grid_ids[..., 0], grid_ids[..., 1], grid_ids[..., 2]
    return ((row >= 0) & (row < gs) & (col >= 0) & (col < gs)
            & (h >= 0) & (h < vh))


def voxel_linear_id(grid_ids: torch.Tensor, gs: int, vh: int) -> torch.Tensor:
    """(row, col, h) -> row * gs * vh + col * vh + h, int32 (3e7 ids at
    gs=1000, vh=30)."""
    return (grid_ids[..., 0] * (gs * vh) + grid_ids[..., 1] * vh
            + grid_ids[..., 2]).to(torch.int32)
