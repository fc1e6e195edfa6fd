"""VisualMap: localise a query image against the mapping trajectory.

Counterpart of ``avlmaps_tpu/map/visual_map.py``.  The reference wraps
HLoc -- NetVLAD global retrieval, SuperPoint + SuperGlue matching and a
depth-lifted PnP for a metric relative pose (avlmaps/map/visual_map.py,
utils/localization_utils.py:408-558).  As in the JAX package:

* global retrieval: a batched product of the query's descriptor with the
  cached per-frame descriptors (CLIP ViT-B/32's image tower by default,
  NetVLAD when its ``.mat`` is configured); caches are kept PER ENCODER
  DIM (``visual_map/global_descriptors_<dim>.h5df``, dataset
  ``descriptors``), so switching encoders keeps the other's file.  The
  port writes and reads them with its own HDF5 codec (``map/hdf5.py``),
  in the layout h5py reads and writes;
* local matching: SuperPoint with SuperGlue or the mutual-NN matcher on
  the device, or ORB + cross-checked Hamming (needs OpenCV);
* the metric solve lifts the reference keypoints with the stored depth
  and runs OpenCV's ``solvePnPRansac``; ``localize_image`` falls back to
  the retrieved frame's pose when matching or the solve fails.

Each stage of an image query runs under a ``record_function`` range:
``query.image.retrieve`` (the global descriptor and its product),
``query.image.superpoint`` (the query's extraction), ``query.image.ref``
(the retrieved frame's cached features, loaded on a miss),
``query.image.decide`` (the matches out of the assignment and their copy
to the host; SuperGlue opens ``query.image.gnn`` and
``query.image.sinkhorn`` itself) and ``query.image.pnp`` (the depth lift
and the solve).  ``stats`` counts queries, reference-feature misses,
valid keypoints, matches and solves, from values already on the host.

``_to_gray`` reproduces OpenCV's uint8 RGB -> gray rounding in numpy, so
SuperPoint sees the same pixels with or without OpenCV.  The ORB path and
the solve need OpenCV and raise ``ImportError`` naming it where it is
absent.  ``localize_image`` catches only the solver's own failures
(``cv2.error``, ``numpy.linalg.LinAlgError``; too few matches return
None): an import or device fault surfaces instead of silently becoming
the retrieval pose (the JAX package catches every ``Exception``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.map import hdf5
from avlmaps_torch.utils.device import resolve_device, to_device

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _require_cv2(what: str):
    if cv2 is None:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is "
                          "not installed")
    return cv2


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's ``cvtColor(rgb, COLOR_RGB2GRAY)`` for uint8 images, to the
    bit: Y = (9798 R + 19235 G + 3735 B + 2^14) >> 15 (its fixed-point
    0.299 / 0.587 / 0.114 at 15 bits)."""
    if rgb.dtype != np.uint8:
        raise ValueError(f"rgb_to_gray_u8 takes uint8 images, not "
                         f"{rgb.dtype}")
    c = rgb.astype(np.int32)
    y = c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


class VisualMap:
    """The visual map.  Encoders it makes (CLIP ViT-B/32, NetVLAD,
    SuperPoint, SuperGlue from their checkpoints) and the mutual-NN
    matcher run on ``device`` (default ``"cuda"``; raises without a
    card)."""

    # habitat camera (x right, y up, z backward) <-> OpenCV camera
    # (x right, y down, z forward)
    _HAB2CV = np.diag([1.0, -1.0, -1.0, 1.0])

    def __init__(self, map_config, data_dir: str = "", clip_encoder=None,
                 superpoint=None, superpoint_ckpt: Optional[str] = None,
                 netvlad_ckpt: Optional[str] = None, superglue=None,
                 superglue_ckpt: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.map_config = map_config
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir) if data_dir else None
        self.descriptors: Optional[np.ndarray] = None
        self.poses: Optional[np.ndarray] = None  # (N, 4, 4) base tfs
        self.clip_encoder = clip_encoder
        # the reference retrieves with hloc's NetVLAD
        # (localization_utils.py:134-136): loaded when its .mat is
        # configured, else CLIP's image tower
        if netvlad_ckpt is None:
            netvlad_ckpt = getattr(map_config, "netvlad_ckpt", "")
        if clip_encoder is None and netvlad_ckpt:
            from avlmaps_torch.models.netvlad import load_netvlad_encoder

            self.clip_encoder = load_netvlad_encoder(netvlad_ckpt,
                                                     device=self.device)
        # learned local features need real weights: an injected extractor
        # or a checkpoint, else ORB
        self.superpoint = superpoint
        if superpoint_ckpt is None:
            superpoint_ckpt = getattr(map_config, "superpoint_ckpt", "")
        if superpoint is None and superpoint_ckpt:
            from avlmaps_torch.models.superpoint import (
                SuperPointExtractor, load_superpoint_checkpoint)

            sp_cfg, sp_params = load_superpoint_checkpoint(superpoint_ckpt)
            self.superpoint = SuperPointExtractor(sp_cfg, params=sp_params,
                                                  device=self.device)
        # SuperGlue when its checkpoint is configured, else mutual-NN
        self.superglue = superglue
        if superglue_ckpt is None:
            superglue_ckpt = getattr(map_config, "superglue_ckpt", "")
        if superglue is None and superglue_ckpt:
            from avlmaps_torch.models.superglue import (
                SuperGlueMatcher, load_superglue_checkpoint)

            sg_cfg, sg_params = load_superglue_checkpoint(superglue_ckpt)
            self.superglue = SuperGlueMatcher(sg_cfg, params=sg_params,
                                              device=self.device)
        self._rgb_paths = self._depth_paths = None
        self._depth_cache: dict = {}
        self._ref_cache: dict = {}
        self._sp_cache: dict = {}
        # counts over the map's queries (host ints; none costs a sync)
        self.stats = dict.fromkeys(
            ("queries", "ref_misses", "keypoints_query", "keypoints_ref",
             "matches", "pnp_attempted", "pnp_solved"), 0)

    def _init_clip(self):
        if self.clip_encoder is None:
            from avlmaps_torch.models.clip import ClipEncoder

            self.clip_encoder = ClipEncoder("ViT-B/32", device=self.device)
        return self.clip_encoder

    def _feat_dim(self) -> int:
        # an unset encoder lazily becomes the 512-d ViT-B/32: no tower is
        # built just to read its width on a warm-cache load
        return (self.clip_encoder.feat_dim if self.clip_encoder is not None
                else 512)

    def _cache_dir(self) -> Path:
        d = self.data_dir / "visual_map"
        os.makedirs(d, exist_ok=True)
        return d

    def _cache_candidates(self) -> list:
        """Readable descriptor caches, preferred first: this encoder's
        dim, then the unsuffixed legacy name."""
        d = self._cache_dir()
        return [d / f"global_descriptors_{self._feat_dim()}.h5df",
                d / "global_descriptors.h5df"]

    def create_and_load_map(self, data_dir: Union[Path, str],
                            batch_size: int = 64) -> None:
        """Load the cached per-frame global descriptors, or compute and
        cache them (reference compute_global_descriptor,
        localization_utils.py:310-406)."""
        from avlmaps_torch.pipeline.packed import rgb_reader

        self.data_dir = Path(data_dir)
        self._rgb_paths = self._depth_paths = None
        self._depth_cache, self._ref_cache, self._sp_cache = {}, {}, {}
        base_poses = np.loadtxt(self.data_dir / "poses.txt")
        if base_poses.ndim == 1:
            base_poses = base_poses[None]
        self.poses = np.stack([pose_vec_to_tf(v) for v in base_poses])

        for cache in self._cache_candidates():
            if not cache.exists():
                continue
            descs = hdf5.read(cache)["descriptors"]
            if descs.shape == (len(self.poses), self._feat_dim()):
                self.descriptors = descs
                return  # valid; else try the next candidate
        rgb_paths = sorted((self.data_dir / "rgb").glob("*.png"))
        enc = self._init_clip()
        read = rgb_reader(self.data_dir, rgb_paths)
        self.descriptors = np.zeros((len(rgb_paths), enc.feat_dim),
                                    np.float32)
        for s0 in range(0, len(rgb_paths), batch_size):
            chunk = [read(i) for i in
                     range(s0, min(s0 + batch_size, len(rgb_paths)))]
            self.descriptors[s0:s0 + len(chunk)] = \
                enc.get_imgs_feats_batch(chunk, batch_size)
        hdf5.write(self._cache_dir()
                   / f"global_descriptors_{enc.feat_dim}.h5df",
                   {"descriptors": self.descriptors})

    def retrieve(self, image: np.ndarray, topk: int = 1) -> np.ndarray:
        """Indices of the most similar mapping frames (reference
        localize_agent's retrieval, localization_utils.py:408-447)."""
        with record_function("query.image.retrieve"):
            enc = self._init_clip()
            if (self.descriptors is not None and self.data_dir is not None
                    and self.descriptors.shape[1] != enc.feat_dim):
                # another encoder's descriptors: load or compute this one's
                self.create_and_load_map(self.data_dir)
            q = enc.get_img_feats(image)
            sims = (self.descriptors @ q.T).flatten()
            return np.argsort(sims)[::-1][:topk]

    def _ref_cam_tf(self, frame_id: int) -> np.ndarray:
        """Habitat-frame camera pose of a mapping frame: its base pose
        raised by the sensor height."""
        cam = self.poses[frame_id].copy()
        cam[1, 3] += self.map_config.pose_info.camera_height
        return cam

    def _ensure_paths(self) -> None:
        if self._rgb_paths is None:
            self._rgb_paths = sorted((self.data_dir / "rgb").glob("*.png"))
            self._depth_paths = sorted(
                (self.data_dir / "depth").glob("*.npy"))

    def _ref_depth(self, frame_id: int) -> Optional[np.ndarray]:
        """A mapping frame's depth image (cached)."""
        from avlmaps_torch.pipeline.loader import load_depth

        if frame_id not in self._depth_cache:
            self._ensure_paths()
            if frame_id >= len(self._depth_paths):
                return None
            depth = np.asarray(load_depth(self._depth_paths[frame_id]),
                               np.float64)
            self._depth_cache[frame_id] = depth[..., 0] if depth.ndim == 3 \
                else depth
        return self._depth_cache[frame_id]

    def _ref_frame_features(self, frame_id: int):
        """A mapping frame's ORB keypoints and descriptors (cached)."""
        from avlmaps_torch.pipeline.loader import load_rgb

        cv = _require_cv2("the ORB matcher")
        if frame_id not in self._ref_cache:
            self._ensure_paths()
            if frame_id >= len(self._rgb_paths):
                return None
            gray = rgb_to_gray_u8(load_rgb(self._rgb_paths[frame_id]))
            self._ref_cache[frame_id] = cv.ORB_create(
                nfeatures=2000).detectAndCompute(gray, None)
        return self._ref_cache[frame_id]

    def _sp_frame_features(self, frame_id: int):
        """A mapping frame's SuperPoint features (cached, host arrays)."""
        from avlmaps_torch.pipeline.loader import load_rgb

        if frame_id not in self._sp_cache:
            self._ensure_paths()
            if frame_id >= len(self._rgb_paths):
                return None
            img = load_rgb(self._rgb_paths[frame_id])
            out = self.superpoint.extract(self._to_gray(img)[None])
            feats = {k: v[0] for k, v in out.items()}
            feats["hw"] = img.shape[:2]
            self._sp_cache[frame_id] = feats
            self.stats["ref_misses"] += 1
        return self._sp_cache[frame_id]

    @staticmethod
    def _to_gray(rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB -> f32 gray in [0, 1], OpenCV's rounding."""
        return rgb_to_gray_u8(rgb).astype(np.float32) / 255.0

    def _match_superpoint(self, query_image: np.ndarray, frame_id: int):
        """(ref_pts, query_pts) pixel pairs from SuperPoint + SuperGlue when
        a SuperGlue is set, else SuperPoint + the mutual-NN matcher on the
        device (reference: HLoc's SuperPoint + SuperGlue,
        localization_utils.py:137-145, 247-273)."""
        with record_function("query.image.ref"):
            ref = self._sp_frame_features(frame_id)
        if ref is None:
            return np.zeros((0, 2)), np.zeros((0, 2))
        with record_function("query.image.superpoint"):
            q = self.superpoint.extract(self._to_gray(query_image)[None])
            q = {k: v[0] for k, v in q.items()}
        if self.superglue is not None:
            idx, _ = self.superglue.match(
                {k: v[None] for k, v in q.items()},
                {k: v[None] for k, v in ref.items() if k != "hw"},
                query_image.shape[:2], hw1=ref["hw"])
            with record_function("query.image.decide"):
                idx = _host(idx)[0]
        else:
            from avlmaps_torch.models.superpoint import \
                mutual_nearest_matches

            dev = self.device
            with record_function("query.image.decide"):
                idx, _ = mutual_nearest_matches(
                    to_device(q["descriptors"], dev),
                    to_device(ref["descriptors"], dev),
                    to_device(q["valid"], dev), to_device(ref["valid"], dev))
                idx = _host(idx)
        sel = idx >= 0
        self.stats["keypoints_query"] += int(q["valid"].sum())
        self.stats["keypoints_ref"] += int(ref["valid"].sum())
        self.stats["matches"] += int(sel.sum())
        return ref["keypoints"][idx[sel]], q["keypoints"][sel]

    def _match_orb(self, query_image: np.ndarray, frame_id: int):
        """(ref_pts, query_pts) from ORB + cross-checked Hamming."""
        cv = _require_cv2("the ORB matcher")
        ref = self._ref_frame_features(frame_id)
        if ref is None:
            return np.zeros((0, 2)), np.zeros((0, 2))
        kr, dr = ref
        kq, dq = cv.ORB_create(nfeatures=2000).detectAndCompute(
            rgb_to_gray_u8(query_image), None)
        if dq is None or dr is None:
            return np.zeros((0, 2)), np.zeros((0, 2))
        matches = cv.BFMatcher(cv.NORM_HAMMING, crossCheck=True).match(dr,
                                                                      dq)
        ref_pts = np.asarray([kr[m.queryIdx].pt for m in matches],
                             np.float64).reshape(-1, 2)
        q_pts = np.asarray([kq[m.trainIdx].pt for m in matches],
                           np.float64).reshape(-1, 2)
        return ref_pts, q_pts

    def refine_pose(self, query_image: np.ndarray, frame_id: int,
                    query_intr: np.ndarray, min_matches: int = 12,
                    reproj_error: float = 12.0) -> Optional[np.ndarray]:
        """Metric camera pose of the query by depth-lifted PnP against one
        mapping frame (reference _get_relative_pose_with_depth,
        localization_utils.py:449-515; RANSAC at 12 px, 200 iterations).

        Returns the habitat-frame camera tf, or None when matching fails."""
        ref_depth = self._ref_depth(frame_id)
        if ref_depth is None:
            return None
        if self.superpoint is not None:
            ref_pts, q_pts = self._match_superpoint(query_image, frame_id)
        else:
            ref_pts, q_pts = self._match_orb(query_image, frame_id)
        if len(ref_pts) < min_matches:
            return None
        with record_function("query.image.pnp"):
            return self._solve_pose(ref_depth, ref_pts, q_pts, frame_id,
                                    query_intr, min_matches, reproj_error)

    def _solve_pose(self, ref_depth: np.ndarray, ref_pts: np.ndarray,
                    q_pts: np.ndarray, frame_id: int, query_intr: np.ndarray,
                    min_matches: int, reproj_error: float
                    ) -> Optional[np.ndarray]:
        """The depth lift of the matched reference pixels and the RANSAC
        PnP solve of :meth:`refine_pose`."""
        h, w = ref_depth.shape
        inv_ref = np.linalg.inv(np.asarray(self.map_config.calib_matrix()))
        obj_pts, img_pts = [], []
        for (u, v), (qu, qv) in zip(ref_pts, q_pts):
            ui, vi = int(round(u)), int(round(v))
            if not (0 <= ui < w and 0 <= vi < h):
                continue
            z = ref_depth[vi, ui]
            if z <= 0.05 or not np.isfinite(z):
                continue
            obj_pts.append((inv_ref @ np.array([u + 0.5, v + 0.5, 1.0])) * z)
            # the same corner-origin pixel convention on the query side
            img_pts.append((qu + 0.5, qv + 0.5))
        if len(obj_pts) < min_matches:
            return None

        cv = _require_cv2("the PnP solve")
        self.stats["pnp_attempted"] += 1
        ok, rvec, tvec, inliers = cv.solvePnPRansac(
            np.asarray(obj_pts, np.float64), np.asarray(img_pts, np.float64),
            np.asarray(query_intr, np.float64), None,
            reprojectionError=reproj_error, iterationsCount=200,
            flags=cv.SOLVEPNP_ITERATIVE)
        if not ok or inliers is None or len(inliers) < min_matches // 2:
            return None
        rot, _ = cv.Rodrigues(rvec)
        # T_qr maps ref-cam (cv) points into the query-cam (cv) frame
        t_qr = np.eye(4)
        t_qr[:3, :3] = rot
        t_qr[:3, 3] = tvec.reshape(3)
        ref_cam_cv = self._ref_cam_tf(frame_id) @ self._HAB2CV
        query_cam_cv = ref_cam_cv @ np.linalg.inv(t_qr)
        self.stats["pnp_solved"] += 1
        return query_cam_cv @ np.linalg.inv(self._HAB2CV)

    def localize_image(self, image: np.ndarray,
                       query_cam_intrinsic_mat: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Query image -> (camera tf, base tf) in the habitat frame
        (reference visual_map.py:59-80): retrieval, then the depth-lifted
        PnP refinement; the retrieved frame's pose when that fails."""
        if self.descriptors is None:
            raise RuntimeError("call create_and_load_map first")
        self.stats["queries"] += 1
        best = int(self.retrieve(image, topk=1)[0])
        cam_tf: Optional[np.ndarray] = None
        if self.data_dir is not None and (self.data_dir / "depth").exists():
            intr = query_cam_intrinsic_mat
            if intr is None:
                # the reference's query intrinsics: the image size at a
                # 90 degree fov (localization_utils.py)
                from avlmaps_torch.geometry.projection import \
                    get_sim_cam_mat_with_fov

                intr = get_sim_cam_mat_with_fov(image.shape[0],
                                                image.shape[1], 90)
            solver_errors = (np.linalg.LinAlgError,) + (
                (cv2.error,) if cv2 is not None else ())
            try:
                cam_tf = self.refine_pose(image, best, intr)
            except solver_errors:
                cam_tf = None
        if cam_tf is None:
            cam_tf = self._ref_cam_tf(best)
        base_tf = cam_tf.copy()
        base_tf[1, 3] -= self.map_config.pose_info.camera_height
        return cam_tf, base_tf
