"""Multi-floor VLMap builder: global camera poses, scene-fitted grid bounds.

Counterpart of ``avlmaps_tpu/map/vlmap_builder_multi_floor.py``
(reference: avlmaps/map/vlmap_builder_multi_floor.py), which builds a
whole-building map keyed by global *camera* poses and sizes the grid from
a first pass over the point cloud (pcd_min/max).

Pass 1, :meth:`VLMapBuilderMultiFloor.probe_bounds`, reads every
``max(1, sample_stride // 10)``-th depth frame and every ``sample_stride``-th
valid point of it; the grid is then fixed, with the height range padded by
a margin.  Pass 2 fuses every frame into that grid with the same step as
the single-floor builder (sliding-window LSeg, backprojection, the
ConceptFusion weight, :func:`fuse_points`) on an offset grid: row = x,
col = z, height = y up, each relative to pcd_min and truncated toward
zero, so a point the probe did not see that lies less than a cell below
pcd_min still lands in row, column or height 0.

On-disk schema: the reference's multi-floor variant
(``vlmap_multi_floor/vlmaps_multi_floor.h5df`` with pcd_min/pcd_max/cs),
written and read by the port's HDF5 codec (map/hdf5.py) with the dtypes
h5py gives the JAX package's file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.geometry.grid import voxel_linear_id
from avlmaps_torch.geometry.projection import (apply_mat3,
                                               depth_to_pointcloud,
                                               get_sim_cam_mat)
from avlmaps_torch.map import hdf5
from avlmaps_torch.map.vlmap import OpenVocabIndexMixin
from avlmaps_torch.map.vlmap_builder import sample_pixels
from avlmaps_torch.models.lseg.window import features_at_points, plan_windows
from avlmaps_torch.ops.voxel_fusion import (VoxelFusionState,
                                            concept_fusion_alpha,
                                            export_fusion_state, fuse_points,
                                            init_fusion_state)
from avlmaps_torch.pipeline.loader import load_depth
from avlmaps_torch.utils.device import resolve_device

# global frame: y up, x right, z backward; camera z forward -> rotate 180
# about x before applying the pose (reference :76-79)
HABITAT2CAM_ROT = np.diag([1.0, -1.0, -1.0, 1.0])


def save_multi_floor_map(save_path, grid_feat, grid_pos, weight,
                         occupied_ids, mapped_iter_list, grid_rgb,
                         pcd_min, pcd_max, cs) -> None:
    """The JAX package's datasets with the dtypes h5py writes for them:
    ``mapped_iter_list`` i32, ``pcd_min``/``pcd_max`` f64, ``cs`` an f64
    scalar."""
    hdf5.write(save_path, {
        "mapped_iter_list": np.asarray(sorted(mapped_iter_list), np.int32),
        "grid_feat": np.asarray(grid_feat), "grid_pos": np.asarray(grid_pos),
        "weight": np.asarray(weight),
        "occupied_ids": np.asarray(occupied_ids),
        "grid_rgb": np.asarray(grid_rgb),
        "pcd_min": np.asarray(pcd_min, np.float64),
        "pcd_max": np.asarray(pcd_max, np.float64),
        "cs": np.asarray(cs, np.float64),
    })


def load_multi_floor_map(map_path):
    """(mapped_iter_list, grid_feat, grid_pos, weight, occupied_ids,
    grid_rgb, pcd_min, pcd_max, cs)."""
    f = hdf5.read(map_path)
    return (f["mapped_iter_list"].tolist(), f["grid_feat"], f["grid_pos"],
            f["weight"], f["occupied_ids"], f["grid_rgb"], f["pcd_min"],
            f["pcd_max"], float(f["cs"][()]))


class VLMapBuilderMultiFloor:
    """Whole-building map from globally-posed camera frames, built on
    ``device`` (default ``"cuda"``; raises without a card).

    ``lseg_apply(images) -> features`` is the pixel-feature network at
    full crop resolution on normalised NHWC crops, e.g. ``net`` itself:
    the multi-floor step materialises the whole sliding-window canvas
    (the JAX package's ``half_res_apply=False``).  ``mesh=`` (the
    multi-device build) raises ``NotImplementedError``."""

    def __init__(self, data_dir, map_config, rgb_paths: Sequence,
                 depth_paths: Sequence, pose_tfs: Sequence[np.ndarray],
                 lseg_apply: Optional[Callable] = None, feat_dim: int = 512,
                 batch_size: int = 8, height_margin_m: float = 1.0,
                 seed: int = 0, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "multi-device (mesh) builds are not ported yet "
                "(ROADMAP.md, Queue 1 item 11)")
        self.data_dir = Path(data_dir)
        self.map_config = map_config
        self.rgb_paths = list(rgb_paths)
        self.depth_paths = list(depth_paths)
        # full cam->global transforms (pose @ rot180x, reference :104-106)
        self.pose_tfs = [np.asarray(tf) @ HABITAT2CAM_ROT
                         for tf in pose_tfs]
        self.lseg_apply = lseg_apply
        self.feat_dim = feat_dim
        self.batch_size = batch_size
        self.height_margin_m = height_margin_m
        self.rng = np.random.default_rng(seed)
        self.map_save_dir = self.data_dir / "vlmap_multi_floor"
        self.map_save_path = self.map_save_dir / "vlmaps_multi_floor.h5df"
        self.pcd_min: Optional[np.ndarray] = None
        self.pcd_max: Optional[np.ndarray] = None

    def _make_loader(self, batch_size: int):
        """PackedLoader when ``<data_dir>/scene.avpack`` matches the frame
        list (depth in f32 metres), else the PNG/npy prefetcher; batches
        land on the device from the producer thread."""
        from avlmaps_torch.pipeline.loader import PrefetchLoader
        from avlmaps_torch.pipeline.packed import PackedLoader, open_matching

        scene = open_matching(self.data_dir, self.rgb_paths,
                              self.depth_paths)
        if scene is not None:
            return PackedLoader(scene, self.pose_tfs, batch_size=batch_size,
                                depth_metres=True, device=self.device)
        return PrefetchLoader(self.rgb_paths, self.depth_paths,
                              self.pose_tfs, batch_size=batch_size,
                              normalize=False, device=self.device)

    # -- pass 1: bounds probe ------------------------------------------------

    def probe_bounds(self, sample_stride: int = 50,
                     max_depth: float = 10.0) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """Min/max of the global point cloud from sampled depth pixels
        (replaces the reference's open3d accumulation pass, :92-117): the
        points backprojected in f32 on the device, the pose applied in f64
        on the host, as in the JAX package."""
        cfg = self.map_config
        inv = torch.tensor(np.linalg.inv(cfg.calib_matrix()),
                           dtype=torch.float32, device=self.device)
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)
        for i in range(0, len(self.depth_paths), max(1, sample_stride // 10)):
            depth = torch.from_numpy(np.asarray(
                load_depth(self.depth_paths[i]), np.float32)).to(self.device)
            pc, mask = depth_to_pointcloud(depth, inv, cfg.min_depth,
                                           max_depth)
            pc = pc[mask].cpu().numpy()[::sample_stride]
            if pc.size == 0:
                continue
            tf = self.pose_tfs[i]
            pg = pc @ tf[:3, :3].T + tf[:3, 3]
            mins = np.minimum(mins, pg.min(axis=0))
            maxs = np.maximum(maxs, pg.max(axis=0))
        margin = np.array([0.0, self.height_margin_m, 0.0])
        self.pcd_min = mins - margin
        self.pcd_max = maxs + margin
        return self.pcd_min, self.pcd_max

    # -- pass 2: fusion ------------------------------------------------------

    def grid_dims(self) -> Tuple[int, int, int, int]:
        """(gs, vh, n_rows, n_cols) of the probed bounds: dims =
        ceil((pcd_max - pcd_min) / cs + 1) in f64, gs = max(rows, cols)."""
        dims = np.ceil((self.pcd_max - self.pcd_min)
                       / self.map_config.cell_size + 1).astype(int)
        n_rows, vh, n_cols = int(dims[0]), int(dims[1]), int(dims[2])
        return max(n_rows, n_cols), vh, n_rows, n_cols

    def _make_geometry(self, gs: int, vh: int, h: int, w: int,
                       height: int, width: int, max_depth: float = 10.0):
        """Offset-grid unproject chain: sampled depth -> global points ->
        (row=x, col=z, h=y_up) grid ids relative to pcd_min (reference
        :118-166's math, batched).  Returns ``geometry(z, sample_idx,
        pose) -> (gid (B, N, 3), fx, fy, alpha, valid)``, the contract of
        vlmap_builder.make_unproject."""
        cfg = self.map_config
        cs = cfg.cell_size
        dev = self.device
        inv_calib = torch.tensor(np.linalg.inv(cfg.calib_matrix()),
                                 dtype=torch.float32, device=dev)
        feat_intr = torch.tensor(get_sim_cam_mat(height, width),
                                 dtype=torch.float32, device=dev)
        pcd_min = torch.tensor(self.pcd_min, dtype=torch.float32, device=dev)

        def geometry(z, sample_idx, pose):
            px = (sample_idx % w).to(torch.float32)
            py = (sample_idx // w).to(torch.float32)
            uv1 = torch.stack([px + 0.5, py + 0.5, torch.ones_like(px)],
                              dim=-1)
            pc_local = apply_mat3(inv_calib, uv1) * z[..., None]
            zmask = (z > cfg.min_depth) & (z < max_depth)
            pg = apply_mat3(pose[:, :3, :3], pc_local) + pose[:, None, :3, 3]
            # offset-shifted grid ids, truncated toward zero (jnp.trunc)
            rel = (pg - pcd_min) / cs
            row = torch.trunc(rel[..., 0]).to(torch.int32)
            hh = torch.trunc(rel[..., 1]).to(torch.int32)
            col = torch.trunc(rel[..., 2]).to(torch.int32)
            in_grid = ((row >= 0) & (row < gs) & (col >= 0) & (col < gs)
                       & (hh >= 0) & (hh < vh))
            uvw = apply_mat3(feat_intr, pc_local)
            fx = torch.trunc(uvw[..., 0] / uvw[..., 2] - 0.5).to(torch.int32)
            fy = torch.trunc(uvw[..., 1] / uvw[..., 2] - 0.5).to(torch.int32)
            in_feat = (fx >= 0) & (fx < width) & (fy >= 0) & (fy < height)
            alpha = concept_fusion_alpha(pc_local)
            gid = torch.stack([row, col, hh], dim=-1)
            return gid, fx, fy, alpha, zmask & in_grid & in_feat

        return geometry

    def create_global_map(self, progress: bool = True):
        """Probe (unless done), fuse every frame, save; returns
        (grid_feat, grid_pos, weight, occupied_ids, grid_rgb)."""
        cfg = self.map_config
        dev = self.device
        os.makedirs(self.map_save_dir, exist_ok=True)
        if self.pcd_min is None:
            self.probe_bounds()
        gs, vh, _, _ = self.grid_dims()

        h, w = np.asarray(load_depth(self.depth_paths[0])).shape[:2]
        max_pts = cfg.point_budget(h, w)
        base_size = getattr(cfg, "lseg_base_size", 520)
        crop_size = getattr(cfg, "lseg_crop_size", 480)
        height, width, _, _, _ = plan_windows(h, w, base_size, crop_size)
        geometry = self._make_geometry(gs, vh, h, w, height, width)
        lseg_apply = self.lseg_apply

        def step(state: VoxelFusionState, rgb, depth, pose, sample_idx,
                 fvalid) -> VoxelFusionState:
            if not rgb.is_floating_point():
                rgb = rgb.to(torch.float32) * (1.0 / 127.5) - 1.0
            if not depth.is_floating_point():  # millimetres
                depth = depth.to(torch.float32) * 1e-3
            b = rgb.shape[0]
            idx = sample_idx.long()
            z = torch.gather(depth.reshape(b, -1), 1, idx)
            gid, fx, fy, alpha, valid = geometry(z, sample_idx, pose)
            feats = features_at_points(lseg_apply, rgb, fx, fy, base_size,
                                       crop_size, half_res_apply=False)
            rgb_u8 = (rgb * 0.5 + 0.5) * 255.0
            rgbs = torch.gather(rgb_u8.reshape(b, -1, 3), 1,
                                idx[..., None].expand(-1, -1, 3))
            valid = valid & fvalid[:, None]
            vids = torch.clamp(voxel_linear_id(gid, gs, vh).reshape(-1), 0,
                               gs * gs * vh - 1)
            d = feats.shape[-1]
            # dedup_scatter=None: K4 on a CUDA state, index_add_ on the CPU
            return fuse_points(state, vids, feats.reshape(-1, d),
                               rgbs.reshape(-1, 3), alpha.reshape(-1),
                               valid.reshape(-1), gs=gs, vh=vh)

        state = init_fusion_state(gs, vh, self.feat_dim, cfg.capacity,
                                  device=dev)
        loader = self._make_loader(self.batch_size)
        mapped = set()
        with torch.no_grad():
            for batch in loader:
                idx = sample_pixels(self.rng, h, w, cfg.depth_sample_rate,
                                    max_pts, self.batch_size)
                fv = torch.from_numpy(batch.frame_ids >= 0).to(dev)
                state = step(state, batch.rgb, batch.depth, batch.pose_tf,
                             torch.from_numpy(idx).to(dev), fv)
                mapped.update(int(i) for i in batch.frame_ids if i >= 0)
                if progress:
                    print(f"\rMultiFloor: {len(mapped)} frames", end="",
                          flush=True)
        if progress:
            print()
        return self._save(state, gs, vh, mapped)

    def _save(self, state: VoxelFusionState, gs: int, vh: int, mapped):
        grid_feat, grid_pos, weight, occupied_ids, grid_rgb = \
            export_fusion_state(state, gs, vh)
        save_multi_floor_map(self.map_save_path, grid_feat, grid_pos, weight,
                             occupied_ids, mapped, grid_rgb, self.pcd_min,
                             self.pcd_max, self.map_config.cell_size)
        return grid_feat, grid_pos, weight, occupied_ids, grid_rgb


class VLMapMultiFloor(OpenVocabIndexMixin):
    """Query-side wrapper for the multi-floor artifact with the
    single-floor VLMap's open-vocabulary API (reference
    vlmap_multi_floor.py:111-144): ``init_categories`` scores with K8,
    ``index_map`` without preloaded categories with K7, on ``device``
    (default ``"cuda"``; raises without a card)."""

    def __init__(self, map_config, data_dir: str = "", clip_encoder=None,
                 clip_ckpt: str = "",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.map_config = map_config
        self.data_dir = Path(data_dir) if data_dir else None
        self.grid_feat = None
        self.grid_pos = None
        self.weight = None
        self.occupied_ids = None
        self.grid_rgb = None
        self.pcd_min = None
        self.pcd_max = None
        self.cs = None
        self.scores_mat = None
        self.categories: Optional[List[str]] = None
        self.clip_encoder = clip_encoder
        self.clip_ckpt = clip_ckpt

    def load_map(self, data_dir) -> bool:
        path = Path(data_dir) / "vlmap_multi_floor" \
            / "vlmaps_multi_floor.h5df"
        if not path.exists():
            return False
        (self.mapped_iter_list, self.grid_feat, self.grid_pos, self.weight,
         self.occupied_ids, self.grid_rgb, self.pcd_min, self.pcd_max,
         self.cs) = load_multi_floor_map(path)
        return True

    def grid_to_global(self, grid_pos: np.ndarray) -> np.ndarray:
        """(row, col, h) -> global (x, y_up, z)."""
        out = np.empty((grid_pos.shape[0], 3), np.float64)
        out[:, 0] = self.pcd_min[0] + grid_pos[:, 0] * self.cs
        out[:, 1] = self.pcd_min[1] + grid_pos[:, 2] * self.cs
        out[:, 2] = self.pcd_min[2] + grid_pos[:, 1] * self.cs
        return out

    def get_pos(self, name: str):
        """Top-down contours/centers/bboxes of a category's islands over the
        whole building (reference get_pos, :177-206; the multi-floor grid
        pools along its y-up axis)."""
        from avlmaps_torch.map.map_base import get_segment_islands_pos
        from avlmaps_torch.ops.pooling import pool_3d_label_to_2d

        assert self.categories
        mask = self.index_map(name, with_init_cat=True)
        gs = self.occupied_ids.shape[0]
        mask_2d = pool_3d_label_to_2d(mask, self.grid_pos, gs)
        return get_segment_islands_pos(mask_2d, 1)[:3]
