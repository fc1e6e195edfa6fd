"""Voxel scatter-accumulate fusion, the map-construction hot path.

Counterpart of ``avlmaps_tpu/ops/voxel_fusion.py``; the design is the same
(reference loop: avlmaps/map/vlmap_builder.py:136-178).  Each voxel slot
stores Σ(w·feat), Σ(w·rgb), Σw and its (row, col, h) in ONE wide f32
accumulator row, the running mean is Σ(w·f)/Σw on read, and slots are
allocated with static shapes: one composite-key sort, first occurrences
flagged, contiguous ranks by cumulative sum.  Invalid and overflowing
points land in the trash slot (row ``capacity``), whose contents are
unspecified.

Where the JAX package donates the state buffers to a jitted update, the
port updates ``occupied_flat`` and ``accum`` IN PLACE: a
:class:`VoxelFusionState` passed to :func:`fuse_points` is mutated and
returned.  On CUDA the accumulate goes through the K4 or K5 kernel
(ops/segment_scatter.py), by the JAX package's routes; on the CPU
through their plain ``index_add_`` versions.  No step waits on the
device: counters stay 0-d tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.ops.segment_scatter import (
    sorted_segment_scatter_add, sorted_segment_scatter_add_split)
from avlmaps_torch.utils.device import resolve_device

INT32_MAX = int(np.iinfo(np.int32).max)

# accumulator columns beyond feat_dim: rgb (3) + w (1) + pos (3) + zero pad
# up to D + 128 (the JAX package's lane multiple; kept so the two states
# have one layout)
ACCUM_PAD = 128


@dataclass
class VoxelFusionState:
    """Device-resident accumulator state.

    ``occupied_flat`` is the dense voxel -> slot table flattened to 1-D:
    index = row * gs * vh + col * vh + h, -1 = empty.  ``accum`` columns
    are ``[Σw·feat (D) | Σw·rgb (3) | Σw (1) | (row, col, h) (3) | 0 pad]``.
    """

    occupied_flat: torch.Tensor  # (gs*gs*vh,) int32
    accum: torch.Tensor  # (capacity+1, D+128) f32; last row = trash slot
    n_slots: torch.Tensor  # () int32 -- the reference's max_id
    n_dropped: torch.Tensor  # () int32 -- points lost to capacity overflow

    @property
    def feat_dim(self) -> int:
        return self.accum.shape[-1] - ACCUM_PAD

    @property
    def sum_wfeat(self) -> torch.Tensor:
        return self.accum[..., :self.feat_dim]

    @property
    def sum_wrgb(self) -> torch.Tensor:
        return self.accum[..., self.feat_dim:self.feat_dim + 3]

    @property
    def sum_w(self) -> torch.Tensor:
        return self.accum[..., self.feat_dim + 3]

    @property
    def grid_pos(self) -> torch.Tensor:
        d = self.feat_dim
        return self.accum[..., d + 4:d + 7].to(torch.int32)


def init_fusion_state(gs: int, vh: int, feat_dim: int, capacity: int,
                      device: Union[str, torch.device] = "cuda",
                      n_rows: Optional[int] = None) -> VoxelFusionState:
    """Fresh accumulators.  The +1 row on per-slot arrays is the trash
    slot.  ``n_rows``: a row shard's occupied table covers only that many
    of the gs rows (default: the whole grid)."""
    dev = resolve_device(device)
    rows = gs if n_rows is None else n_rows
    return VoxelFusionState(
        occupied_flat=torch.full((rows * gs * vh,), -1, dtype=torch.int32,
                                 device=dev),
        accum=torch.zeros((capacity + 1, feat_dim + ACCUM_PAD),
                          dtype=torch.float32, device=dev),
        n_slots=torch.zeros((), dtype=torch.int32, device=dev),
        n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )


def concept_fusion_alpha(points_local: torch.Tensor,
                         sigma_sq: float = 0.6) -> torch.Tensor:
    """ConceptFusion distance weight α = exp(-|p|² / (2σ²)), σ² = 0.6
    (reference vlmap_builder.py:156-158)."""
    radial_dist_sq = torch.sum(points_local * points_local, dim=-1)
    return torch.exp(-radial_dist_sq / (2.0 * sigma_sq))


@dataclass
class SortedBatch:
    """One fusion batch in the accumulate's sorted order (see
    :func:`sort_batch`)."""

    slots: torch.Tensor  # (B,) int32 ascending final slots
    feats: torch.Tensor  # (B, D) features in slot order
    w: torch.Tensor  # (B,) f32 weights, 0 for invalid points
    aux: torch.Tensor  # (B, ACCUM_PAD) f32 [w·rgb | w | (row, col, h) | 0]
    n_unique: torch.Tensor  # () int32 first-seen voxels of the batch
    n_dropped: torch.Tensor  # () int32 points lost to capacity overflow


def sort_batch(state: VoxelFusionState, vids: torch.Tensor,
               feats: torch.Tensor, rgbs: torch.Tensor, alphas: torch.Tensor,
               valid: torch.Tensor, *, gs: int, vh: int,
               n_rows: Optional[int] = None) -> SortedBatch:
    """Allocate the batch's new slots in ``state.occupied_flat`` (in place)
    and return its rows sorted by final slot, ready for the accumulate.
    ``n_rows``: see :func:`fuse_points`."""
    capacity = state.accum.shape[0] - 1
    b = vids.shape[0]
    n_vox = (gs if n_rows is None else n_rows) * gs * vh
    if n_vox + capacity + 1 >= INT32_MAX:
        raise ValueError(f"grid of {n_vox} voxels + capacity {capacity} "
                         "overflows the int32 fusion sort key")

    vids = vids.to(torch.int32)
    safe_vids = torch.where(valid, vids, 0)
    slot0 = state.occupied_flat[safe_vids.long()]  # -1 = unseen

    # ONE stable sort orders allocation AND the accumulate: allocated
    # voxels key by slot, first-seen voxels by capacity+1+vid (their slots
    # are handed out in vid order, so key order is final-slot order),
    # invalid points last.  jnp.argsort is stable too, so the slot
    # allocation is the JAX package's, point for point.
    key = torch.where(valid,
                      torch.where(slot0 >= 0, slot0, capacity + 1 + safe_vids),
                      INT32_MAX)
    perm = torch.argsort(key, stable=True)
    sk = key[perm]

    is_new = (sk > capacity) & (sk < INT32_MAX)
    vid_s = torch.where(is_new, sk - (capacity + 1), 0)
    first = is_new.clone()
    first[1:] &= sk[1:] != sk[:-1]
    rank = torch.cumsum(first, 0, dtype=torch.int32) - 1
    n_unique = first.sum(dtype=torch.int32)
    cand = state.n_slots + rank
    fits = cand < capacity
    slot_s = torch.where(is_new, torch.where(fits, cand, capacity),
                         torch.clamp(sk, max=capacity)).to(torch.int32)
    designated = first & fits  # the one point that allocates each new slot

    # table update in place: designated rows write their new slot (the
    # voxel held -1), every other row writes -1 under max, a no-op -- the
    # JAX package drops those rows with mode="drop" instead
    state.occupied_flat.scatter_reduce_(
        0, torch.where(designated, vid_s, 0).long(),
        torch.where(designated, slot_s, -1), reduce="amax")

    w = torch.where(valid, alphas, 0.0).to(torch.float32)[perm]
    vrow = vid_s // (gs * vh)
    vcol = (vid_s // vh) % gs
    vhh = vid_s % vh
    pos_add = (torch.stack([vrow, vcol, vhh], dim=1).to(torch.float32)
               * designated[:, None])
    aux = torch.cat([
        w[:, None] * rgbs.to(torch.float32)[perm],
        w[:, None],
        pos_add,
        torch.zeros((b, ACCUM_PAD - 7), dtype=torch.float32,
                    device=w.device),
    ], dim=1)
    return SortedBatch(
        slots=slot_s, feats=feats[perm].contiguous(), w=w, aux=aux,
        n_unique=n_unique,
        n_dropped=torch.sum((sk < INT32_MAX) & (slot_s == capacity),
                            dtype=torch.int32))


def fuse_points(state: VoxelFusionState, vids: torch.Tensor,
                feats: torch.Tensor, rgbs: torch.Tensor, alphas: torch.Tensor,
                valid: torch.Tensor, *, gs: int, vh: int,
                n_rows: Optional[int] = None,
                dedup_scatter: Optional[bool] = None,
                scatter_split: bool = True) -> VoxelFusionState:
    """Fuse one batch of weighted point features into the accumulators.

    vids: (B,) int32 flat voxel ids; feats: (B, D) f32 or bf16; rgbs:
    (B, 3) f32; alphas: (B,) f32; valid: (B,) bool.  Per valid point with
    weight α: allocate ``occupied[vid]`` if empty, then
    ``sum_wfeat += α·feat``, ``sum_wrgb += α·rgb``, ``sum_w += α``.
    Mutates and returns ``state``.

    ``n_rows`` serves row-sharded grids (parallel/sharded.py): the state's
    occupied table covers only ``n_rows`` of the gs rows and the vids are
    shard-local (local_row * gs * vh + col * vh + h).  Defaults to the
    whole grid.

    The accumulate takes the JAX package's routes: ``dedup_scatter`` with
    ``scatter_split`` -> K4 (which hands batches it cannot take to K5);
    ``dedup_scatter`` alone -> the assembled update through K5; no dedup ->
    ``index_add_``, the counterpart of the JAX package's XLA scatter.
    ``dedup_scatter=None`` means on for a CUDA state, as the JAX default is
    on its accelerator.  The TPU grid's ``scatter_block_rows`` has no
    counterpart.
    """
    if dedup_scatter is None:
        dedup_scatter = state.accum.is_cuda
    sb = sort_batch(state, vids, feats, rgbs, alphas, valid, gs=gs, vh=vh,
                    n_rows=n_rows)
    if dedup_scatter and scatter_split:
        sorted_segment_scatter_add_split(state.accum, sb.slots, sb.feats,
                                         sb.w, sb.aux)
    else:
        update = torch.cat([sb.w[:, None] * sb.feats.float(), sb.aux], dim=1)
        if dedup_scatter:
            sorted_segment_scatter_add(state.accum, sb.slots, update)
        else:
            state.accum.index_add_(0, sb.slots.long(), update)

    capacity = state.accum.shape[0] - 1
    state.n_slots = torch.clamp(state.n_slots + sb.n_unique, max=capacity)
    state.n_dropped = state.n_dropped + sb.n_dropped
    return state


def export_bucket(n: int, minimum: int = 4096) -> int:
    """Slice length for exporting ``n`` occupied slots: the next power of
    two (>= minimum)."""
    return max(minimum, 1 << max(int(n) - 1, 0).bit_length())


def _device_export(state: VoxelFusionState, bucket: int):
    """Slice the first ``bucket`` slots and finish the weighted mean on the
    device, so the device->host copy scales with occupancy."""
    d = state.feat_dim
    a = state.accum[:bucket]
    sum_w = a[:, d + 3]
    denom = torch.where(sum_w > 0, sum_w, 1.0)[:, None]
    grid_feat = a[:, :d] / denom
    grid_rgb = a[:, d:d + 3] / denom
    grid_pos = a[:, d + 4:d + 7].to(torch.int32)
    rgb_u8 = torch.clamp(grid_rgb, 0, 255).to(torch.uint8)
    return grid_feat, grid_pos, sum_w, rgb_u8


def occupied_from_grid_pos(grid_pos: np.ndarray, gs: int,
                           vh: int) -> np.ndarray:
    """Rebuild the dense slot table from the per-slot positions
    (``grid_pos[slot] = (r, c, h)`` inverts exactly)."""
    occ = np.full((gs, gs, vh), -1, np.int32)
    occ[grid_pos[:, 0], grid_pos[:, 1], grid_pos[:, 2]] = np.arange(
        grid_pos.shape[0], dtype=np.int32)
    return occ


def export_fusion_state(state: VoxelFusionState, gs: int, vh: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Device accumulators -> the reference's storage form: (grid_feat
    (N, D) weighted mean, grid_pos (N, 3), weight (N,), occupied_ids
    (gs, gs, vh), grid_rgb (N, 3) uint8), N = n_slots."""
    n = int(state.n_slots)
    bucket = min(export_bucket(n), state.accum.shape[0])
    grid_feat, grid_pos, sum_w, grid_rgb = (
        t.cpu().numpy() for t in _device_export(state, bucket))
    grid_feat, grid_pos = grid_feat[:n], grid_pos[:n]
    sum_w, grid_rgb = sum_w[:n], grid_rgb[:n]
    occupied_ids = occupied_from_grid_pos(grid_pos, gs, vh)
    return (grid_feat.astype(np.float32), grid_pos.astype(np.int32),
            sum_w.astype(np.float32), occupied_ids, grid_rgb)


def restore_fusion_state(gs: int, vh: int, capacity: int,
                         grid_feat: np.ndarray, grid_pos: np.ndarray,
                         weight: np.ndarray, occupied_ids: np.ndarray,
                         grid_rgb: Optional[np.ndarray] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> VoxelFusionState:
    """Resume fusion from a saved map (reference vlmap_builder.py:211-224);
    the accumulator is built on the device, only N rows cross the link."""
    dev = resolve_device(device)
    n, d = grid_feat.shape
    if n > capacity:
        raise ValueError(f"saved map has {n} slots > capacity {capacity}")
    rows = np.zeros((n, d + ACCUM_PAD), np.float32)
    rows[:, d + 3] = weight
    rows[:, :d] = grid_feat * weight[:, None]
    if grid_rgb is not None:
        rows[:, d:d + 3] = grid_rgb.astype(np.float32) * weight[:, None]
    rows[:, d + 4:d + 7] = grid_pos.astype(np.float32)
    accum = torch.zeros((capacity + 1, d + ACCUM_PAD), dtype=torch.float32,
                        device=dev)
    accum[:n] = torch.from_numpy(rows).to(dev)
    return VoxelFusionState(
        occupied_flat=torch.from_numpy(
            occupied_ids.reshape(-1).astype(np.int32)).to(dev),
        accum=accum,
        n_slots=torch.tensor(n, dtype=torch.int32, device=dev),
        n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )
