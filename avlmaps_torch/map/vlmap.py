"""VLMap: the visual-language voxel map with open-vocabulary indexing.

Counterpart of ``avlmaps_tpu/map/vlmap.py`` (reference
avlmaps/map/vlmap.py): load the voxel artifact, score ``grid_feat``
against template-ensembled CLIP text features, take the per-voxel argmax
as the category mask, and the CLIP-driven obstacle customisation.  The
scoring runs on ``device`` through K8 (``init_categories``) and K7
(``index_map`` without preloaded categories, ``customize_obstacle_map``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from avlmaps_torch.config import MapConfig
from avlmaps_torch.map.map_base import Map, get_segment_islands_pos
from avlmaps_torch.map.voxel_map import load_3d_map
from avlmaps_torch.ops.morphology import (binary_closing, binary_dilation,
                                          gaussian_blur)
from avlmaps_torch.ops.pooling import pool_3d_label_to_2d
from avlmaps_torch.utils.category_matching import find_similar_category_id
from avlmaps_torch.utils.device import resolve_device, to_device


def load_lseg_params(path: str):
    """LSeg weights from the reference's ``.ckpt``/``.pt`` as this
    package's state_dict.  Pre-ported ``.msgpack`` files need flax and
    are read by the JAX package only."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            "pre-ported .msgpack LSeg weights need flax; the port reads the "
            "reference .ckpt (ROADMAP.md, Queue 1)")
    from avlmaps_torch.models.lseg.port import load_lseg_checkpoint

    return load_lseg_checkpoint(str(path))


class OpenVocabIndexMixin:
    """Open-vocabulary indexing over ``self.grid_feat``: CLIP set-up
    (checkpoint-aware), category pre-scoring, the fused score + argmax
    query and the serving query."""

    def _init_clip(self, clip_version: str = "ViT-B/32"):
        """Lazy CLIP set-up (reference vlmap.py:67-90): the OpenAI .pt when
        a checkpoint is configured, seeded random weights otherwise
        (variant from map_config.clip_variant when set)."""
        if self.clip_encoder is not None:
            return self.clip_encoder
        from avlmaps_torch.models.clip import ClipEncoder

        if getattr(self, "clip_ckpt", ""):
            self.clip_encoder = ClipEncoder.from_checkpoint(
                self.clip_ckpt, device=self.device)
        else:
            variant = getattr(getattr(self, "map_config", None),
                              "clip_variant", "") or clip_version
            self.clip_encoder = ClipEncoder(variant, device=self.device)
        return self.clip_encoder

    def init_categories(self, categories: List[str]) -> np.ndarray:
        """Pre-score the map against a fixed category list with K8
        (reference vlmap.py:92-102); (N, C+1) host scores."""
        self.categories = list(categories)
        enc = self._init_clip()
        self.scores_mat = enc.get_lseg_score(
            self.categories, self.grid_feat, use_multiple_templates=True,
            add_other=True)
        return self.scores_mat

    def index_map(self, language_desc: str,
                  with_init_cat: bool = True) -> np.ndarray:
        """Per-voxel boolean mask for a language query
        (reference vlmap.py:104-125)."""
        if with_init_cat and self.scores_mat is not None and self.categories:
            cat_id = find_similar_category_id(language_desc, self.categories)
            return np.argmax(self.scores_mat, axis=1) == cat_id
        if with_init_cat:
            raise Exception(
                "Categories are not preloaded. Call "
                "init_categories(categories: List[str]) to initialize "
                "categories.")
        return self._init_clip().get_lseg_argmax(
            [language_desc], self.grid_feat, use_multiple_templates=True,
            add_other=True) == 0

    def make_serving_query(self, other_categories: List[str] = ("other",),
                           decay_rate: float = 0.01, k: int = 64,
                           **delivery_kw):
        """Bind the serving query (ops/delivery.make_text_object_query) to
        this loaded map: CLIP template encode -> K7 against the
        pre-encoded ``other_categories`` -> dense EDT heat -> goal / top-k
        heads.

        Returns ``query(name) -> dict`` of device tensors (``goal_pos``,
        ``topk_vals``/``topk_pos``, ``heat``); fetch with
        ops.delivery.fetch_np.  The map features ride the encoder's device
        cache and the positions are uploaded once here, so a query
        uploads only its token ids."""
        from avlmaps_torch.ops.delivery import make_text_object_query

        enc = self._init_clip()
        other = enc.get_text_feats_multiple_templates(
            list(other_categories), as_device=True)
        fused = make_text_object_query(
            enc, self.occupied_ids.shape, cell_size=self.cs,
            decay_rate=decay_rate, k=k, device=self.device, **delivery_kw)
        feats_dev = enc._map_feats_device(
            self.grid_feat.reshape(-1, self.grid_feat.shape[-1]))
        pos_dev = to_device(self.grid_pos, self.device, torch.int32)

        def query(name: str):
            return fused(name, feats_dev, pos_dev, other)

        return query

    def index_map_sharded(self, mesh, language_desc: str) -> np.ndarray:
        raise NotImplementedError(
            "row-sharded multi-device indexing is not ported yet "
            "(ROADMAP.md, Queue 1 item 11)")


class VLMap(OpenVocabIndexMixin, Map):
    """The voxel VLMap on ``device`` (default ``"cuda"``; raises without a
    card): the CLIP encoder it makes, the scoring kernels and the heat
    run there; the map itself stays in host arrays as in the JAX
    package."""

    def __init__(self, map_config: MapConfig, data_dir: str = "",
                 clip_encoder=None, lseg_ckpt: str = "",
                 clip_ckpt: str = "",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        super().__init__(map_config, data_dir=data_dir)
        self.scores_mat: Optional[np.ndarray] = None
        self.categories: Optional[List[str]] = None
        self.clip_encoder = clip_encoder
        self.lseg_ckpt = lseg_ckpt
        self.clip_ckpt = clip_ckpt
        self._lseg = None  # (apply_fn, feat_dim) injected for map creation

    # -- model wiring --------------------------------------------------------

    def set_lseg(self, apply_fn, feat_dim: int = 512):
        """Inject the pixel-feature network for :meth:`create_map`:
        ``apply_fn(images) -> half-resolution features``, e.g.
        ``lambda x: net(x, upsample=False)``."""
        self._lseg = (apply_fn, feat_dim)

    def _default_lseg(self):
        """LSeg for map creation: the configured checkpoint when given,
        seeded random weights otherwise (reference _init_lseg,
        avlmaps/map/vlmap_builder.py:226-264)."""
        if self._lseg is None:
            from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                                   cast_params_for_inference,
                                                   init_params)

            arch = getattr(self.map_config, "lseg_arch", "vitl16")
            # the archs whose output geometry the evaluators accept
            # (patch 16: output == crop, or half of it)
            if arch not in ("vitl16", "medium", "tiny16"):
                raise ValueError(f"unknown lseg_arch {arch!r}")
            # the kernels of a ViT block on a card compute in bf16
            dtype = (torch.bfloat16 if arch == "vitl16"
                     or self.device.type == "cuda" else torch.float32)
            cfg = getattr(LSegConfig, arch)(dtype)
            net = LSegNet(cfg, device=self.device)
            if self.lseg_ckpt:
                params = load_lseg_params(self.lseg_ckpt)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(0)
                params = init_params(cfg, gen)
            net.load_state_dict(params, strict=True)
            if dtype == torch.bfloat16:
                cast_params_for_inference(net)
            net.eval().requires_grad_(False)
            self._lseg = (lambda x: net(x, upsample=False), cfg.out_dim)
        return self._lseg

    # -- create / load -------------------------------------------------------

    def create_map(self, data_dir: Union[Path, str],
                   batch_size: int = 4) -> None:
        """Build the voxel map for a scene with the port's builder
        (reference vlmap.py:33-48)."""
        from avlmaps_torch.map.vlmap_builder import VLMapBuilder

        self._setup_paths(data_dir)
        apply_fn, feat_dim = self._default_lseg()
        builder = VLMapBuilder(
            self.data_dir, self.map_config, self.pose_path, self.rgb_paths,
            self.depth_paths, self.base2cam_tf, self.base_transform,
            lseg_apply=apply_fn, feat_dim=feat_dim, batch_size=batch_size,
            half_res_apply=True, device=self.device)
        pose_type = self.map_config.pose_info.pose_type
        if pose_type == "mobile_base":
            builder.create_mobile_base_map()
        elif pose_type == "camera":
            builder.create_camera_map()
        else:
            raise ValueError(f"unknown pose_type {pose_type!r}")

    def load_map(self, data_dir: Union[Path, str]) -> bool:
        self._setup_paths(data_dir)
        self.map_save_path = Path(data_dir) / "vlmap" / "vlmaps.h5df"
        if not self.map_save_path.exists():
            print("Loading VLMap failed because the file doesn't exist.")
            return False
        (self.mapped_iter_list, self.grid_feat, self.grid_pos, self.weight,
         self.occupied_ids, self.grid_rgb) = load_3d_map(self.map_save_path)
        return True

    # -- indexing: init_categories / index_map from OpenVocabIndexMixin ------

    def customize_obstacle_map(self, potential_obstacle_names: List[str],
                               obstacle_names: List[str],
                               vis: bool = False) -> None:
        """CLIP-scored dynamic obstacle mask with K7 (reference
        vlmap.py:127-156 + index_utils.get_dynamic_obstacles_map_3d
        :138-184)."""
        if self.obstacles_cropped is None and self.obstacles_map is None:
            self.generate_obstacle_map()
        all_obstacles_mask = self.obstacles_cropped == 0
        # add_other=True: an appended 'other' class absorbs non-obstacle
        # voxels (index_utils.py:152-158)
        predict = self._init_clip().get_lseg_argmax(
            list(potential_obstacle_names), self.grid_feat,
            use_multiple_templates=True, add_other=True)
        obs_inds = [i for i, name in enumerate(potential_obstacle_names)
                    if name in obstacle_names]
        pts_mask = np.isin(predict, obs_inds)

        new_obstacles = np.zeros_like(self.obstacles_cropped, dtype=bool)
        obs_pts = self.grid_pos[pts_mask]
        rows = obs_pts[:, 0] - self.rmin
        cols = obs_pts[:, 1] - self.cmin
        inside = ((rows >= 0) & (rows < new_obstacles.shape[0])
                  & (cols >= 0) & (cols < new_obstacles.shape[1]))
        new_obstacles[rows[inside], cols[inside]] = True
        new_obstacles &= all_obstacles_mask
        new_obstacles = ~new_obstacles

        dilated = Map._dilate_map(new_obstacles == 0,
                                  self.map_config.dilate_iter,
                                  self.map_config.gaussian_sigma)
        self.obstacles_new_cropped = dilated == 0

    def get_pos(self, name: str):
        """Contours, centres and bboxes of a category's islands on the full
        map (reference vlmap.py:158-187)."""
        assert self.categories
        pc_mask = self.index_map(name, with_init_cat=True)
        mask_2d = pool_3d_label_to_2d(pc_mask, self.grid_pos, self.gs)
        mask_2d = mask_2d[self.rmin:self.rmax + 1, self.cmin:self.cmax + 1]

        fg = binary_closing(torch.from_numpy(mask_2d), iterations=3)
        fg = gaussian_blur(fg.float(), sigma=0.8, truncate=3.0) > 0.5
        fg = binary_dilation(fg).numpy()

        contours, centers, bbox_list, _ = get_segment_islands_pos(fg, 1)
        # shift back to whole-map coords (reference vlmap.py:176-185)
        for i in range(len(contours)):
            centers[i][0] += self.rmin
            centers[i][1] += self.cmin
            bbox_list[i][0] += self.rmin
            bbox_list[i][1] += self.rmin
            bbox_list[i][2] += self.cmin
            bbox_list[i][3] += self.cmin
            contours[i] = contours[i] + np.array([[self.rmin, self.cmin]])
        return contours, centers, bbox_list
