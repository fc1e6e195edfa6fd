"""AreaMap: one global CLIP image feature per frame, with its robot pose.

Counterpart of ``avlmaps_tpu/map/area_map.py`` (reference
avlmaps/map/area_map.py): the "sparse CLIP map" holds a ViT-L/14 image
embedding per trajectory frame; a query is the text-image cosine score
of every pose.  Frames are encoded in batches through
:meth:`ClipEncoder.get_imgs_feats_batch` on the encoder's device.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.map.voxel_map import (load_clip_sparse_map,
                                         save_clip_sparse_map)
from avlmaps_torch.utils.category_matching import find_similar_category_id


class AreaMap:
    """The area map; the CLIP encoder it makes runs on ``device`` (default
    ``"cuda"``; raises without a card)."""

    def __init__(self, data_dir: str = "", clip_encoder=None,
                 clip_version: str = "ViT-L/14",
                 device: Union[str, torch.device] = "cuda"):
        self.clip_sparse_map: Optional[np.ndarray] = None
        self.robot_pose_list = None
        self.categories: Optional[List[str]] = None
        self.scores_mat: Optional[np.ndarray] = None
        self.clip_version = clip_version
        self.clip_encoder = clip_encoder
        self.device = device
        if data_dir:
            self._setup_paths(data_dir)

    def _init_clip(self):
        """Lazy CLIP ViT-L/14 (reference area_map.py:27-50), seeded random
        weights unless an encoder was given."""
        if self.clip_encoder is None:
            from avlmaps_torch.models.clip import ClipEncoder

            self.clip_encoder = ClipEncoder(self.clip_version,
                                            device=self.device)
        return self.clip_encoder

    @property
    def clip_feat_dim(self) -> int:
        return self._init_clip().feat_dim

    def _setup_paths(self, data_dir: Union[Path, str]) -> None:
        self.data_dir = Path(data_dir)
        self.rgb_dir = self.data_dir / "rgb"
        self.pose_path = self.data_dir / "poses.txt"
        self.map_save_dir = self.data_dir / "area_map"
        os.makedirs(self.map_save_dir, exist_ok=True)
        self.rgb_paths = sorted(self.rgb_dir.glob("*.png"))

    def create_map(self, data_dir: Union[Path, str],
                   batch_size: int = 64) -> None:
        """Encode every frame with CLIP and store (features, poses)
        (reference area_map.py:65-92), a batch at a time: a trajectory
        decoded at once is gigabytes of host memory."""
        from avlmaps_torch.pipeline.packed import rgb_reader

        with record_function("area.setup"):
            self._setup_paths(data_dir)
            enc = self._init_clip()
            base_poses = np.loadtxt(self.pose_path)
            if base_poses.ndim == 1:
                base_poses = base_poses[None]
            read = rgb_reader(self.data_dir, self.rgb_paths)
            n = len(self.rgb_paths)
            feats = np.zeros((n, enc.feat_dim), np.float32)
        for s0 in range(0, n, batch_size):
            with record_function("area.read"):
                chunk = [read(i) for i in range(s0, min(s0 + batch_size, n))]
            feats[s0:s0 + len(chunk)] = enc.get_imgs_feats_batch(
                chunk, batch_size)
        self.clip_sparse_map = feats
        self.robot_pose_list = [pose_vec_to_tf(v) for v in base_poses]
        with record_function("area.save"):
            save_clip_sparse_map(self.map_save_dir / "clip_sparse_map.h5df",
                                 self.clip_sparse_map, self.robot_pose_list)

    def load_map(self, data_dir: Union[Path, str]) -> None:
        self._setup_paths(data_dir)
        self.clip_sparse_map, self.robot_pose_list = load_clip_sparse_map(
            self.map_save_dir / "clip_sparse_map.h5df")

    def init_categories(self, categories: List[str]) -> np.ndarray:
        """(reference area_map.py:99-103)."""
        self.categories = list(categories)
        text_feats = self._init_clip().get_text_feats(self.categories)
        self.scores_mat = self.clip_sparse_map @ text_feats.T
        return self.scores_mat

    def index_map(self, language_desc: str,
                  with_init_cat: bool = True) -> np.ndarray:
        """Per-pose scores for a text query (reference
        area_map.py:105-119)."""
        if with_init_cat and self.scores_mat is not None and self.categories:
            cat_id = find_similar_category_id(language_desc, self.categories)
            return self.scores_mat[:, cat_id].flatten()
        if with_init_cat:
            raise Exception(
                "Categories are not preloaded. Call init_categories("
                "categories: List[str]) to initialize categories.")
        text_feats = self._init_clip().get_text_feats([language_desc])
        return (self.clip_sparse_map @ text_feats.T).flatten()
