"""VLMap builder: the map-construction pipeline on a CUDA card.

Counterpart of ``avlmaps_tpu/map/vlmap_builder.py`` (reference flow:
avlmaps/map/vlmap_builder.py:54-185).  Per batch of frames, one device
step runs the sliding-window LSeg forward, backprojects the sampled depth
pixels, transforms them to the map frame, computes grid ids and the
ConceptFusion weight and fuses the batch into the voxel accumulators.  A
producer thread decodes frames (or copies them out of a packed scene) and
copies each batch to the card ahead of the step.  Every single-device
build of the JAX package is here:

- ``transport="canvas"``, ``sampling="host"`` (the default): the producer
  draws the pixel subsample with numpy (the same generator as the JAX
  package, so the draws are bit-identical) and ships the lean canvas
  batch (``make_frame_step_canvas``);
- ``transport="canvas"``, ``sampling="device"``: the producer ships the
  canvas and the full-res uint16 depth plane, and the step draws the
  pixels on the card with JAX's threefry bits
  (``make_frame_step_device_sampled``, utils/threefry.py): no per-point
  host work;
- ``transport="frame"``: full uint8 frames, resized on the card
  (``make_frame_step``), pixels drawn on the host;
- ``mesh=`` (parallel/sharded.py): frames data-parallel over the mesh's
  shards, the grid row-sharded, pixels drawn on the host.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from avlmaps_torch.geometry.grid import (base_pos_to_grid_id,
                                         out_of_range_mask, voxel_linear_id)
from avlmaps_torch.geometry.projection import apply_mat3, get_sim_cam_mat
from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.map.voxel_map import SparseVoxelMap, load_3d_map
from avlmaps_torch.models.lseg.window import (features_at_points,
                                              plan_windows,
                                              whole_canvas_features_at_points)
from avlmaps_torch.ops.voxel_fusion import (VoxelFusionState,
                                            concept_fusion_alpha,
                                            export_fusion_state, fuse_points,
                                            init_fusion_state,
                                            restore_fusion_state)
from avlmaps_torch.utils import threefry
from avlmaps_torch.utils.device import resolve_device
from avlmaps_torch.utils.profiling import RateMeter


def make_unproject(*, gs: int, cs: float, vh: int, calib_mat: np.ndarray,
                   image_hw: Tuple[int, int], base_size: int, crop_size: int,
                   min_depth: float, max_depth: float,
                   device: Union[str, torch.device] = "cuda"):
    """The backproject -> map frame -> grid id -> canvas projection chain
    (reference vlmap_builder.py:126-160, mapping_utils.py:226-251).

    Returns ``unproject(z, sample_idx, pose) -> (gid, fx, fy, alpha,
    valid)``: (B, N, 3) grid ids, canvas feature coords, ConceptFusion
    alpha and the depth/grid/canvas validity mask."""
    dev = resolve_device(device)
    h, w = image_hw
    height, width, _, _, _ = plan_windows(h, w, base_size, crop_size)
    feat_intr = torch.tensor(get_sim_cam_mat(height, width),
                             dtype=torch.float32, device=dev)
    inv_calib = torch.tensor(np.linalg.inv(calib_mat), dtype=torch.float32,
                             device=dev)

    def unproject(z, sample_idx, pose):
        px = (sample_idx % w).to(torch.float32)
        py = (sample_idx // w).to(torch.float32)
        # backproject at the +0.5 pixel centres (reference depth2pc)
        uv1 = torch.stack([px + 0.5, py + 0.5, torch.ones_like(px)], dim=-1)
        pc_local = apply_mat3(inv_calib, uv1) * z[..., None]  # (B, N, 3)
        zmask = (z > min_depth) & (z < max_depth)
        pc_global = apply_mat3(pose[:, :3, :3], pc_local) \
            + pose[:, None, :3, 3]
        gid = base_pos_to_grid_id(gs, cs, pc_global)
        in_grid = out_of_range_mask(gid, gs, vh)
        # canvas feature coords through the canvas intrinsics (reference
        # pix_feats_intr, vlmap_builder.py:126,141-143)
        uvw = apply_mat3(feat_intr, pc_local)
        fx = torch.trunc(uvw[..., 0] / uvw[..., 2] - 0.5).to(torch.int32)
        fy = torch.trunc(uvw[..., 1] / uvw[..., 2] - 0.5).to(torch.int32)
        in_feat = (fx >= 0) & (fx < width) & (fy >= 0) & (fy < height)
        alpha = concept_fusion_alpha(pc_local)
        return gid, fx, fy, alpha, zmask & in_grid & in_feat

    return unproject


def make_point_geometry(*, gs: int, cs: float, vh: int,
                        calib_mat: np.ndarray, image_hw: Tuple[int, int],
                        base_size: int, crop_size: int, min_depth: float,
                        max_depth: float, n_rows: Optional[int] = None,
                        row_offset: int = 0,
                        device: Union[str, torch.device] = "cuda"):
    """make_unproject plus linear voxel ids and static row ownership.
    Returns ``geometry(z, sample_idx, pose) -> (vids, fx, fy, alpha,
    valid)``: ids of the ``n_rows`` grid rows from ``row_offset`` on (the
    whole grid by default), row-rebased and clipped into that range
    (invalid points carry a clipped id), and the depth/grid/canvas/
    ownership validity mask."""
    unproject = make_unproject(
        gs=gs, cs=cs, vh=vh, calib_mat=calib_mat, image_hw=image_hw,
        base_size=base_size, crop_size=crop_size, min_depth=min_depth,
        max_depth=max_depth, device=device)
    rows = gs if n_rows is None else n_rows

    def geometry(z, sample_idx, pose):
        gid, fx, fy, alpha, valid = unproject(z, sample_idx, pose)
        vids, owned = own_rows(gid, gs=gs, vh=vh, n_rows=rows,
                               row_offset=row_offset)
        return vids, fx, fy, alpha, valid & owned

    return geometry


def own_rows(gid: torch.Tensor, *, gs: int, vh: int, n_rows: int,
             row_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row ownership of grid ids ``gid`` (..., 3) for the ``n_rows`` grid
    rows from ``row_offset`` on: the row-rebased linear voxel ids, clipped
    into that range, and the mask of the points those rows own."""
    local_row = gid[..., 0] - row_offset
    owned = (local_row >= 0) & (local_row < n_rows)
    lgid = torch.cat([local_row[..., None], gid[..., 1:]], dim=-1)
    vids = torch.clamp(voxel_linear_id(lgid, gs, vh), 0,
                       n_rows * gs * vh - 1)
    return vids, owned


def _canvas_features(lseg_apply: Callable, lseg_eval: str, canvas, fx, fy,
                     base_size: int, crop_size: int, half_res_apply: bool):
    if lseg_eval == "whole":
        return whole_canvas_features_at_points(lseg_apply, canvas, fx, fy)
    return features_at_points(lseg_apply, canvas, fx, fy, base_size,
                              crop_size, half_res_apply=half_res_apply)


def _check_eval(lseg_eval: str) -> None:
    if lseg_eval not in ("sliding", "whole"):
        raise ValueError(f"lseg_eval={lseg_eval!r}: use 'sliding' or "
                         "'whole'")


def make_frame_step(lseg_apply: Callable, *, gs: int, cs: float, vh: int,
                    calib_mat: np.ndarray, image_hw: Tuple[int, int],
                    base_size: int = 520, crop_size: int = 480,
                    min_depth: float = 0.1, max_depth: float = 6.0,
                    half_res_apply: bool = False, rgb_uint8: bool = False,
                    dedup_scatter: Optional[bool] = None,
                    device: Union[str, torch.device] = "cuda") -> Callable:
    """The device step for one full-frame batch (the frame transport).

    Returns ``step(state, rgb, depth, pose, sample_idx, frame_valid) ->
    state``: ``rgb`` (B, H, W, 3) normalised, or uint8 normalised on the
    device with ``rgb_uint8=True``; ``depth`` (B, H, W) f32 metres, or
    integer millimetres (a uint16 plane as the loader ships it); the
    canvas resize runs on the device inside the sliding window.
    ``dedup_scatter``: see ``fuse_points`` (None = on for a CUDA state)."""
    geometry = make_point_geometry(
        gs=gs, cs=cs, vh=vh, calib_mat=calib_mat, image_hw=image_hw,
        base_size=base_size, crop_size=crop_size, min_depth=min_depth,
        max_depth=max_depth, device=device)

    def step(state: VoxelFusionState, rgb: torch.Tensor,
             depth: torch.Tensor, pose: torch.Tensor,
             sample_idx: torch.Tensor,
             frame_valid: torch.Tensor) -> VoxelFusionState:
        rgb_norm = (rgb.to(torch.float32) * (1.0 / 127.5) - 1.0
                    if rgb_uint8 else rgb)
        if not depth.is_floating_point():  # millimetres
            depth = depth.to(torch.float32) * 1e-3
        b = rgb_norm.shape[0]
        idx = sample_idx.long()
        z = torch.gather(depth.reshape(b, -1), 1, idx)  # (B, N)
        vids, fx, fy, alpha, valid = geometry(z, sample_idx, pose)
        feats = features_at_points(lseg_apply, rgb_norm, fx, fy, base_size,
                                   crop_size, half_res_apply=half_res_apply)
        # colour at the sampled pixel, back from the normalised frame
        rgb_u8 = (rgb_norm * 0.5 + 0.5) * 255.0
        rgbs = torch.gather(rgb_u8.reshape(b, -1, 3), 1,
                            idx[..., None].expand(-1, -1, 3))
        valid = valid & frame_valid[:, None]
        d = feats.shape[-1]
        return fuse_points(
            state, vids.reshape(-1), feats.reshape(-1, d),
            rgbs.reshape(-1, 3), alpha.reshape(-1), valid.reshape(-1),
            gs=gs, vh=vh, dedup_scatter=dedup_scatter)

    return step


def make_frame_step_canvas(lseg_apply: Callable, *, gs: int, cs: float,
                           vh: int, calib_mat: np.ndarray,
                           image_hw: Tuple[int, int], base_size: int = 520,
                           crop_size: int = 480, min_depth: float = 0.1,
                           max_depth: float = 6.0,
                           half_res_apply: bool = True,
                           lseg_eval: str = "sliding",
                           dedup_scatter: Optional[bool] = None,
                           device: Union[str, torch.device] = "cuda"
                           ) -> Callable:
    """The device step for one CanvasBatch (pipeline.transport).

    ``lseg_apply(images) -> features``; ``lseg_eval="sliding"`` is the
    reference's count-normalised crop grid (lseg_utils.py:77-96),
    ``"whole"`` one forward over the padded canvas.  Returns
    ``step(state, canvas_u8, z_mm, rgb_pts, pose, sample_idx,
    frame_valid) -> state`` (the state is updated in place)."""
    _check_eval(lseg_eval)
    geometry = make_point_geometry(
        gs=gs, cs=cs, vh=vh, calib_mat=calib_mat, image_hw=image_hw,
        base_size=base_size, crop_size=crop_size, min_depth=min_depth,
        max_depth=max_depth, device=device)

    def step(state: VoxelFusionState, canvas_u8: torch.Tensor,
             z_mm: torch.Tensor, rgb_pts: torch.Tensor, pose: torch.Tensor,
             sample_idx: torch.Tensor,
             frame_valid: torch.Tensor) -> VoxelFusionState:
        with record_function("build.geometry"):
            z = z_mm.to(torch.float32) * 1e-3  # (B, N) metres
            vids, fx, fy, alpha, valid = geometry(z, sample_idx, pose)
            valid = valid & frame_valid[:, None]
        with record_function("build.lseg"):
            canvas = canvas_u8.to(torch.float32) * (1.0 / 127.5) - 1.0
            feats = _canvas_features(lseg_apply, lseg_eval, canvas, fx, fy,
                                     base_size, crop_size, half_res_apply)
        d = feats.shape[-1]
        with record_function("build.fuse"):
            return fuse_points(
                state, vids.reshape(-1), feats.reshape(-1, d),
                rgb_pts.to(torch.float32).reshape(-1, 3), alpha.reshape(-1),
                valid.reshape(-1), gs=gs, vh=vh, dedup_scatter=dedup_scatter)

    return step


def device_sample_indices(frame_ids: torch.Tensor, *, seed: int,
                          max_pts: int, n_pixels: int) -> torch.Tensor:
    """The device sampler's draws: for each frame, ``max_pts`` flat pixel
    indices ``randint(fold_in(PRNGKey(seed), frame_id), (max_pts,), 0,
    n_pixels)`` -- the JAX package's threefry bits, exactly -- sorted
    ascending.  (B,) int32 ids -> (B, max_pts) int64, on their device."""
    key = threefry.fold_in(threefry.prng_key(seed), frame_ids)
    idx = threefry.randint(key, max_pts, 0, n_pixels)
    return torch.sort(idx, dim=1).values


def make_frame_step_device_sampled(
        lseg_apply: Callable, *, gs: int, cs: float, vh: int,
        calib_mat: np.ndarray, image_hw: Tuple[int, int],
        base_size: int = 520, crop_size: int = 480, min_depth: float = 0.1,
        max_depth: float = 6.0, half_res_apply: bool = True,
        lseg_eval: str = "whole", max_pts: int = 7776, seed: int = 0,
        dedup_scatter: Optional[bool] = None,
        device: Union[str, torch.device] = "cuda") -> Callable:
    """The step that samples its pixels on the device, for one
    RawCanvasBatch (the canvas and the full-res uint16 depth plane).

    Returns ``step(state, canvas_u8, depth_mm, pose, frame_ids,
    frame_valid) -> state``.  Per frame the device draws ``max_pts``
    pixels from a threefry fold of the frame id (deterministic per frame,
    so a resumed build draws the same; :func:`device_sample_indices`),
    masks repeated draws after the sort so no pixel fuses twice, gathers
    depth at the samples from the shipped plane, and reads colour from the
    canvas at the align-corners-scaled pixel, ``rint(x * sx)`` (half to
    even in both packages).  Nothing in the step waits on the device."""
    _check_eval(lseg_eval)
    geometry = make_point_geometry(
        gs=gs, cs=cs, vh=vh, calib_mat=calib_mat, image_hw=image_hw,
        base_size=base_size, crop_size=crop_size, min_depth=min_depth,
        max_depth=max_depth, device=device)
    h, w = image_hw
    ch, cw, _, _, _ = plan_windows(h, w, base_size, crop_size)
    sy = (ch - 1) / max(h - 1, 1)
    sx = (cw - 1) / max(w - 1, 1)

    def step(state: VoxelFusionState, canvas_u8: torch.Tensor,
             depth_mm: torch.Tensor, pose: torch.Tensor,
             frame_ids: torch.Tensor,
             frame_valid: torch.Tensor) -> VoxelFusionState:
        b = canvas_u8.shape[0]
        with record_function("build.sample"):
            idx = device_sample_indices(frame_ids, seed=seed,
                                        max_pts=max_pts, n_pixels=h * w)
            dup = torch.zeros_like(idx, dtype=torch.bool)
            dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
            z = torch.gather(depth_mm.reshape(b, -1), 1,
                             idx).to(torch.float32) * 1e-3
            sample_idx = idx.to(torch.int32)
            vids, fx, fy, alpha, valid = geometry(z, sample_idx, pose)
            valid = valid & ~dup & frame_valid[:, None]

        with record_function("build.lseg"):
            canvas = canvas_u8.to(torch.float32) * (1.0 / 127.5) - 1.0
            feats = _canvas_features(lseg_apply, lseg_eval, canvas, fx, fy,
                                     base_size, crop_size, half_res_apply)

        with record_function("build.colour"):
            # colour from the canvas at the scaled source pixel (nearest)
            cx = torch.clamp(torch.round((idx % w).to(torch.float32) * sx),
                             0, cw - 1).long()
            cy = torch.clamp(torch.round((idx // w).to(torch.float32) * sy),
                             0, ch - 1).long()
            rgbs = torch.gather(canvas_u8.reshape(b, -1, 3), 1,
                                (cy * cw + cx)[..., None].expand(-1, -1, 3))
        d = feats.shape[-1]
        with record_function("build.fuse"):
            return fuse_points(
                state, vids.reshape(-1), feats.reshape(-1, d),
                rgbs.to(torch.float32).reshape(-1, 3), alpha.reshape(-1),
                valid.reshape(-1), gs=gs, vh=vh, dedup_scatter=dedup_scatter)

    return step


def sample_pixels(rng: np.random.Generator, h: int, w: int,
                  depth_sample_rate: int, max_pts: int,
                  batch: int) -> np.ndarray:
    """Host-side random pixel subsample: ~h*w/rate unique pixels per frame
    (reference _backproject_depth shuffle, vlmap_builder.py:266-281), padded
    by repetition to the static ``max_pts`` budget.  The same draws as the
    JAX package's for the same generator state."""
    n_target = min(max(h * w // depth_sample_rate, 1), max_pts)
    idx = np.empty((batch, max_pts), np.int32)
    for b in range(batch):
        # oversample with replacement + unique: far cheaper than a
        # permutation at this ratio
        over = rng.integers(0, h * w, int(n_target * 1.3) + 16)
        pick = np.unique(over)
        if pick.shape[0] < n_target:  # extremely unlikely; top up
            extra = rng.choice(h * w, size=n_target - pick.shape[0],
                               replace=False)
            pick = np.concatenate([pick, extra])
        elif pick.shape[0] > n_target:
            # np.unique sorts: subsample the surplus uniformly rather than
            # keep the smallest pixel indices (the top of the frame)
            pick = pick[rng.choice(pick.shape[0], n_target, replace=False)]
        reps = int(np.ceil(max_pts / n_target))
        idx[b] = np.tile(pick, reps)[:max_pts]
    return idx


class VLMapBuilder:
    """Build the sparse voxel VLMap for one scene directory (rgb/*.png,
    depth/*.npy, poses.txt; reference avlmaps/map/map.py:40-52,
    vlmap_builder.py:54-108).

    ``lseg_apply(images) -> features`` is the pixel-feature network on
    normalised NHWC crops, e.g. ``lambda x: net(x, upsample=False)`` with
    ``half_res_apply=True``.  ``transport``: ``"canvas"`` or ``"frame"``
    (None -> the map config's); ``sampling``: ``"host"`` or ``"device"``
    (device sampling needs the canvas transport; with ``"frame"`` it warns
    and samples on the host, as the JAX package does).  A matching
    ``scene.avpack`` (pipeline/packed.py) is read instead of the PNG/npy
    frames.  Runs on ``device`` (default ``"cuda"``; raises without a
    card).

    ``mesh`` (``parallel.make_mesh``) builds on its shards instead
    (:class:`~avlmaps_torch.parallel.ShardedFusion`): the batch is rounded
    down to a multiple of the mesh size (at least one frame a shard),
    ``lseg_apply`` is one callable or one per mesh entry, ``sampling=
    "device"`` warns and samples on the host, and ``device`` is the mesh's
    first.

    The map is saved in ``map_save_dir`` (default ``<data_dir>/vlmap``),
    and a map saved there is resumed.
    """

    def __init__(self, data_dir, map_config, pose_path, rgb_paths,
                 depth_paths, base2cam_tf: np.ndarray,
                 base_transform: np.ndarray, lseg_apply: Callable = None,
                 feat_dim: int = 512, batch_size: int = 8, seed: int = 0,
                 mesh=None, half_res_apply: bool = False,
                 transport: Optional[str] = None, packed_path=None,
                 sampling: str = "host",
                 device: Union[str, torch.device] = "cuda",
                 map_save_dir=None):
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.transport = transport if transport is not None else \
            getattr(map_config, "transport", "canvas")
        if self.transport not in ("canvas", "frame"):
            raise ValueError(f"transport={self.transport!r}: use 'canvas' "
                             "or 'frame'")
        if sampling not in ("host", "device"):
            raise ValueError(f"sampling={sampling!r}: use 'host' or "
                             "'device'")
        self.sampling = sampling
        self.data_dir = Path(data_dir)
        self.map_config = map_config
        self.pose_path = pose_path
        self.rgb_paths = list(rgb_paths)
        self.depth_paths = list(depth_paths)
        self.base2cam_tf = base2cam_tf
        self.base_transform = base_transform
        self.lseg_apply = lseg_apply
        self.feat_dim = feat_dim
        self.batch_size = batch_size
        self.half_res_apply = half_res_apply
        self.packed_path = packed_path
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.map_save_dir = (Path(map_save_dir) if map_save_dir is not None
                             else self.data_dir / "vlmap")
        self.map_save_path = self.map_save_dir / "vlmaps.h5df"

    def create_mobile_base_map(self, save_every: int = 100,
                               progress: bool = True) -> SparseVoxelMap:
        base_poses = np.loadtxt(self.pose_path)
        if base_poses.ndim == 1:
            base_poses = base_poses[None]
        inv_bt = np.linalg.inv(self.base_transform)
        init_base_tf = (self.base_transform @ pose_vec_to_tf(base_poses[0])
                        @ inv_bt)
        inv_init_base_tf = np.linalg.inv(init_base_tf)
        # full cam->map transform per frame (reference vlmap_builder.py:106-133)
        pose_tfs = []
        for vec in base_poses:
            base_pose = self.base_transform @ pose_vec_to_tf(vec) @ inv_bt
            tf = inv_init_base_tf @ base_pose
            pose_tfs.append(tf @ self.base_transform @ self.base2cam_tf)
        return self._build(pose_tfs, save_every, progress)

    def create_camera_map(self, save_every: int = 100,
                          progress: bool = True) -> SparseVoxelMap:
        """The map from CAMERA poses, centred at the first camera frame:
        cam->map is ``B · H0^-1 · Hi · C`` with B the habitat->map axes,
        Hi the habitat camera pose and C the habitat-camera -> CV-camera
        flip (the reference's create_camera_map is a TODO whose docstring
        fixes these semantics, vlmap_builder.py:187-193)."""
        cam2cv = np.diag([1.0, -1.0, -1.0, 1.0])
        cam_poses = np.loadtxt(self.pose_path)
        if cam_poses.ndim == 1:
            cam_poses = cam_poses[None]
        inv_h0 = np.linalg.inv(pose_vec_to_tf(cam_poses[0]))
        pose_tfs = [self.base_transform @ inv_h0 @ pose_vec_to_tf(vec)
                    @ cam2cv for vec in cam_poses]
        return self._build(pose_tfs, save_every, progress)

    def _build(self, pose_tfs, save_every: int,
               progress: bool) -> SparseVoxelMap:
        cfg = self.map_config
        gs, vh = cfg.gs, cfg.vh
        dev = self.device
        # the host work before the first batch: the resume read, the
        # pack's match, the accumulator, the step and the loader
        with record_function("build.setup"):
            os.makedirs(self.map_save_dir, exist_ok=True)

            saved, mapped = self._load_saved()  # resume: skip mapped frames
            scene = self._packed_scene()
            if scene is not None:
                h, w = scene.h, scene.w
            else:
                from avlmaps_torch.pipeline.loader import load_depth

                h, w = np.asarray(load_depth(self.depth_paths[0])).shape[:2]
            max_pts = cfg.point_budget(h, w)
            base_size = getattr(cfg, "lseg_base_size", 520)
            crop_size = getattr(cfg, "lseg_crop_size", 480)
            height, width, _, _, _ = plan_windows(h, w, base_size, crop_size)
            use_canvas = self.transport == "canvas"
            lseg_eval = getattr(cfg, "lseg_eval", "sliding")

            def sampler(b):
                return sample_pixels(self.rng, h, w, cfg.depth_sample_rate,
                                     max_pts, b)

            if self.mesh is not None:
                if self.sampling == "device":
                    warnings.warn(
                        "sampling='device' is not implemented for sharded "
                        "(mesh) builds; using the host sampler", stacklevel=3)
                sharded = self._setup_sharded(
                    scene, pose_tfs, saved, mapped, sampler, (h, w),
                    (height, width), base_size, crop_size, lseg_eval)
            else:
                device_sampling = use_canvas and self.sampling == "device"
                if self.sampling == "device" and not use_canvas:
                    warnings.warn("sampling='device' needs "
                                  "transport='canvas'; using the host "
                                  "sampler", stacklevel=2)
                state, step, loader = self._setup_single(
                    scene, pose_tfs, saved, mapped, sampler, (h, w),
                    (height, width), base_size, crop_size, lseg_eval,
                    max_pts, device_sampling)
        if self.mesh is not None:
            return self._create_sharded(*sharded, mapped, sampler,
                                        save_every, progress)

        def to_device(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            if dev.type == "cuda":  # pinned: the copy does not block
                return t.pin_memory().to(dev, non_blocking=True)
            return t

        done = 0
        meter = RateMeter()
        with torch.no_grad():
            for batch in loader:
                fv = batch.frame_ids >= 0
                # the step's launches and the inputs this thread makes for
                # them; the build.* and lseg.* ranges nest inside
                with record_function("build.step"):
                    fv_t = to_device(fv)
                    if device_sampling:
                        state = step(state, batch.canvas, batch.depth_mm,
                                     batch.pose_tf,
                                     to_device(batch.frame_ids), fv_t)
                    elif use_canvas:
                        state = step(state, batch.canvas, batch.z_mm,
                                     batch.rgb_pts, batch.pose_tf,
                                     batch.sample_idx, fv_t)
                    else:
                        idx = sample_pixels(self.rng, h, w,
                                            cfg.depth_sample_rate, max_pts,
                                            self.batch_size)
                        state = step(state, batch.rgb, batch.depth,
                                     batch.pose_tf, to_device(idx), fv_t)
                n_new = int(fv.sum())
                mapped.update(int(i) for i in batch.frame_ids if i >= 0)
                done += n_new
                rate = meter.update(n_new)
                if progress:
                    rate_s = f" ({rate:.1f} fps)" if rate else ""
                    print(f"\rVLMap: {done} frames fused{rate_s}", end="",
                          flush=True)
                if save_every and done % save_every < self.batch_size:
                    self._save(state, gs, vh, mapped)
        if progress:
            print()
        self.build_stats = {
            "frames": done,
            "voxels": int(state.n_slots),
            "points_dropped": int(state.n_dropped),
            "fps": meter.rate,
        }
        return self._save(state, gs, vh, mapped)

    def _setup_single(self, scene, pose_tfs, saved, mapped, sampler,
                      image_hw, canvas_hw, base_size, crop_size, lseg_eval,
                      max_pts, device_sampling):
        """The one-device build's fusion state (fresh or resumed), frame
        step and loader."""
        cfg = self.map_config
        gs, vh = cfg.gs, cfg.vh
        dev = self.device
        use_canvas = self.transport == "canvas"
        if saved is not None:
            grid_feat, grid_pos, weight, occupied_ids, grid_rgb = saved
            state = restore_fusion_state(gs, vh, cfg.capacity, grid_feat,
                                         grid_pos, weight, occupied_ids,
                                         grid_rgb, device=dev)
        else:
            state = init_fusion_state(gs, vh, self.feat_dim, cfg.capacity,
                                      device=dev)
        common = dict(gs=gs, cs=cfg.cs, vh=vh, calib_mat=cfg.calib_matrix(),
                      image_hw=image_hw, base_size=base_size,
                      crop_size=crop_size, min_depth=cfg.min_depth,
                      max_depth=cfg.max_depth,
                      half_res_apply=self.half_res_apply, device=dev)

        if device_sampling:
            from avlmaps_torch.pipeline.transport import \
                make_raw_canvas_transform

            step = make_frame_step_device_sampled(
                self.lseg_apply, lseg_eval=lseg_eval, max_pts=max_pts,
                seed=self.seed, **common)
            transform = make_raw_canvas_transform(canvas_hw)
        elif use_canvas:
            from avlmaps_torch.pipeline.transport import make_canvas_transform

            step = make_frame_step_canvas(self.lseg_apply,
                                          lseg_eval=lseg_eval, **common)
            transform = make_canvas_transform(sampler, canvas_hw)
        else:
            step = make_frame_step(self.lseg_apply, rgb_uint8=True, **common)
            transform = None
        loader = self._make_loader(scene, pose_tfs, mapped, sampler,
                                   canvas_hw, transform, use_canvas,
                                   device_sampling, self.batch_size, dev)
        return state, step, loader

    def _packed_scene(self):
        """The matching, up-to-date ``.avpack`` (pipeline.packed.
        open_matching), or None -> decode PNG/npy per frame."""
        from avlmaps_torch.pipeline.packed import open_matching

        return open_matching(self.data_dir, self.rgb_paths, self.depth_paths,
                             explicit_path=self.packed_path)

    def _make_loader(self, scene, pose_tfs, mapped, sampler, canvas_hw,
                     transform, use_canvas, raw_canvas, batch_size, device):
        """PackedLoader when a matching pack exists (straight from its
        stored canvas when that has this geometry: the raw canvas and
        depth plane for device sampling, the canvas and host gathers
        otherwise), else PrefetchLoader decoding PNG/npy; batches land on
        ``device`` from the producer (None: host arrays)."""
        if scene is not None:
            from avlmaps_torch.pipeline.packed import PackedLoader

            kw = dict(batch_size=batch_size, skip_ids=mapped, device=device)
            stored = (use_canvas and scene.canvas is not None
                      and tuple(scene.canvas_hw) == tuple(canvas_hw))
            if stored and raw_canvas:
                return PackedLoader(scene, pose_tfs, raw_canvas=True, **kw)
            if stored:
                return PackedLoader(scene, pose_tfs, sampler=sampler, **kw)
            return PackedLoader(scene, pose_tfs, transform=transform,
                                depth_metres=use_canvas, **kw)
        from avlmaps_torch.pipeline.loader import PrefetchLoader

        return PrefetchLoader(self.rgb_paths, self.depth_paths, pose_tfs,
                              batch_size=batch_size, skip_ids=mapped,
                              normalize=False, transform=transform,
                              device=device)

    def _setup_sharded(self, scene, pose_tfs, saved, mapped, sampler,
                       image_hw, canvas_hw, base_size, crop_size, lseg_eval):
        """The multi-device build's fusion (resumed from a saved map by
        re-sharding its slots by row ownership), its loader and its batch
        (rounded down to a multiple of the mesh size).  The loader yields
        host arrays; each shard's block crosses to its device in the
        step."""
        from avlmaps_torch.parallel.sharded import ShardedFusion

        cfg = self.map_config
        gs, vh = cfg.gs, cfg.vh
        n_dev = self.mesh.size
        batch = max(self.batch_size, n_dev) // n_dev * n_dev
        use_canvas = self.transport == "canvas"
        fusion = ShardedFusion(
            self.mesh, gs=gs, cs=cfg.cs, vh=vh, feat_dim=self.feat_dim,
            capacity=cfg.capacity, calib_mat=cfg.calib_matrix(),
            image_hw=image_hw, lseg_apply=self.lseg_apply,
            base_size=base_size, crop_size=crop_size,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth,
            half_res_apply=self.half_res_apply, transport=self.transport,
            lseg_eval=lseg_eval)
        if saved is not None:
            fusion.restore(*saved)

        transform = None
        if use_canvas:
            from avlmaps_torch.pipeline.transport import make_canvas_transform

            transform = make_canvas_transform(sampler, canvas_hw)
        loader = self._make_loader(scene, pose_tfs, mapped, sampler,
                                   canvas_hw, transform, use_canvas, False,
                                   batch, None)
        return fusion, loader, batch

    def _create_sharded(self, fusion, loader, batch, mapped, sampler,
                        save_every, progress) -> SparseVoxelMap:
        """The multi-device build's loop: frames data-parallel over the
        mesh, the grid row-sharded (parallel/sharded.py); saves every
        ``save_every`` fused frames, as the reference's periodic save
        (avlmaps/map/vlmap_builder.py:180-183)."""
        gs, vh = self.map_config.gs, self.map_config.vh
        n_dev = self.mesh.size
        use_canvas = self.transport == "canvas"

        def save() -> SparseVoxelMap:
            with record_function("build.export"):
                exported = fusion.export()
            return self._write(exported, gs, vh, mapped)

        meter = RateMeter()
        done = 0
        with torch.no_grad():
            for b in loader:
                fv = b.frame_ids >= 0
                with record_function("build.step"):
                    if use_canvas:
                        fusion.step(b.canvas, b.z_mm, b.rgb_pts, b.pose_tf,
                                    b.sample_idx, fv)
                    else:
                        fusion.step(b.rgb, b.depth, b.pose_tf,
                                    sampler(batch), fv)
                n_new = int(fv.sum())
                mapped.update(int(i) for i in b.frame_ids if i >= 0)
                done += n_new
                meter.update(n_new)
                if progress:
                    print(f"\rVLMap (sharded x{n_dev}): {done} frames",
                          end="", flush=True)
                if save_every and done % save_every < batch:
                    save()
        if progress:
            print()
        m = save()
        self.build_stats = {
            "frames": done,
            "voxels": int(m.grid_feat.shape[0]),
            "points_dropped": int(sum(int(st.n_dropped)
                                      for st in fusion.states)),
            "fps": meter.rate,
        }
        return m

    def _load_saved(self):
        """Saved map arrays + mapped frame set, or (None, empty) if fresh."""
        if self.map_save_path.exists():
            (mapped_list, grid_feat, grid_pos, weight, occupied_ids,
             grid_rgb) = load_3d_map(self.map_save_path)
            return ((grid_feat, grid_pos, weight, occupied_ids, grid_rgb),
                    set(int(i) for i in mapped_list))
        return None, set()

    def _save(self, state: VoxelFusionState, gs: int, vh: int,
              mapped) -> SparseVoxelMap:
        with record_function("build.export"):
            exported = export_fusion_state(state, gs, vh)
        return self._write(exported, gs, vh, mapped)

    def _write(self, exported, gs: int, vh: int, mapped) -> SparseVoxelMap:
        grid_feat, grid_pos, weight, occupied_ids, grid_rgb = exported
        m = SparseVoxelMap(gs=gs, vh=vh, feat_dim=grid_feat.shape[1],
                           grid_feat=grid_feat, grid_pos=grid_pos,
                           weight=weight, occupied_ids=occupied_ids,
                           grid_rgb=grid_rgb, mapped_iters=set(mapped))
        with record_function("build.save"):
            m.save(self.map_save_path)
        return m
