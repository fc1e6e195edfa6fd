"""AVLMap: the facade over the modality maps, with cross-modal heatmaps.

Counterpart of ``avlmaps_tpu/map/avlmap.py`` (reference
avlmaps/map/avlmap.py): open-vocabulary object queries over the voxel
VLMap, area queries over the sparse CLIP map and sound queries over the
audio event database, each returned as a heatmap in [0, 1] for fusion.
The visual map (image queries by visual localisation) is not ported yet:
``create_map`` and ``load_map`` skip it and ``index_image`` raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from avlmaps_torch.config import AVLMapsConfig
from avlmaps_torch.map.area_map import AreaMap
from avlmaps_torch.map.sound_map import SoundMap
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.ops.heatmap import (decayed_point_heatmap_2d,
                                       heatmap_from_mask_3d)
from avlmaps_torch.ops.pooling import lift_2d_to_3d


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to avlmaps_torch yet (ROADMAP.md, Queue 1 "
        f"{item})")


class AVLMap:
    """The object, area and sound queries on ``device`` (default
    ``"cuda"``; raises without a card): the encoders it makes, the
    scoring kernels and the heat run there."""

    def __init__(self, config: AVLMapsConfig, data_dir: str = "",
                 clip_encoder=None, area_clip_encoder=None,
                 audioclip_encoder=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        clip_ckpt = getattr(config, "clip_ckpt", "")
        audioclip_ckpt = getattr(config, "audioclip_ckpt", "")
        if audioclip_encoder is None and audioclip_ckpt:
            from avlmaps_torch.models.audioclip import AudioClipEncoder
            from avlmaps_torch.models.audioclip.port import \
                load_audioclip_checkpoint

            ac_cfg, ac_params = load_audioclip_checkpoint(audioclip_ckpt)
            audioclip_encoder = AudioClipEncoder(cfg=ac_cfg, params=ac_params,
                                                 device=device)
        if area_clip_encoder is None and (clip_ckpt or getattr(
                config.map_config, "clip_variant", "")):
            # an explicit variant (e.g. "tiny" for tests) or checkpoint:
            # one encoder shared by the area map and the VLMap
            from avlmaps_torch.models.clip import ClipEncoder

            area_clip_encoder = (ClipEncoder.from_checkpoint(clip_ckpt,
                                                             device=device)
                                 if clip_ckpt else
                                 ClipEncoder(config.map_config.clip_variant,
                                             device=device))
        self.vlmap = VLMap(config.map_config, data_dir=data_dir,
                           clip_encoder=clip_encoder or area_clip_encoder,
                           lseg_ckpt=getattr(config, "lseg_ckpt", ""),
                           clip_ckpt=clip_ckpt, device=device)
        self.sound_map = SoundMap(data_dir, config.sound_config,
                                  config.sound_data_collect_params,
                                  is_ambiguous=False, is_real=False,
                                  audioclip_encoder=audioclip_encoder,
                                  device=device)
        self.area_map = AreaMap(data_dir, clip_encoder=area_clip_encoder,
                                device=device)
        self.visual_map = None  # ROADMAP.md, Queue 1 item 6
        self.dataloader = None

    # -- lifecycle (reference avlmap.py:38-56) ----------------------------

    def create_map(self, data_dir: Union[Path, str]) -> bool:
        """Build the VLMap, the area map and the sound map of a scene.  The
        visual map is skipped until it is ported (ROADMAP.md, Queue 1
        item 6)."""
        self.vlmap.create_map(data_dir)
        self.area_map.create_map(data_dir)
        self.sound_map.create_sound_map(data_dir)
        return True

    def load_map(self, data_dir: Union[Path, str]) -> bool:
        """Load the VLMap, the area map and the sound map and build the
        pose converter; the visual map is skipped (Queue 1 item 6)."""
        from avlmaps_torch.dataloader.habitat_dataloader import \
            VLMapsDataloaderHabitat

        self.vlmap.load_map(data_dir)
        self.area_map.load_map(data_dir)
        self.sound_map.load_sound_map(data_dir)
        self.dataloader = VLMapsDataloaderHabitat(
            data_dir, self.config.map_config, self.vlmap)
        return True

    # -- object (reference avlmap.py:67-77) -------------------------------

    def index_object(self, object_name: str,
                     init_categories: Optional[List[str]] = None,
                     decay_rate: float = 0.1, delivery: str = "f32"):
        """Open-vocabulary object heatmap over the voxel map.

        ``delivery`` picks the wire format:

        * ``"f32"``   -- reference-shaped (N,) f32 host array (default);
        * ``"u8"``    -- the same host array, quantised to 1/255 steps on
          the device so a quarter of the bytes cross to the host;
        * ``"device"``-- the (N,) f32 heat left on the device (for
          cross-modal fusion there, ops.delivery.fused_goal_pick);
        * ``"topk"``  -- (values (64,), positions (64, 3)) host arrays;
        * ``"goal"``  -- the argmax voxel position (3,) (what the robot's
          move_to consumes, reference habitat_lang_robot.py:419-430).
        """
        vm = self.vlmap
        if init_categories is not None:
            # the reference strips the first and last entries ('void' and
            # 'objects' of mp3dcat) before scoring (avlmap.py:69)
            vm.init_categories(list(init_categories)[1:-1])
            mask = vm.index_map(object_name, with_init_cat=True)
        else:
            mask = vm.index_map(object_name, with_init_cat=False)
        heat = heatmap_from_mask_3d(vm.grid_pos, mask,
                                    cell_size=self.config.params.cs,
                                    decay_rate=decay_rate,
                                    grid_shape=vm.occupied_ids.shape,
                                    as_device=delivery != "f32",
                                    device=vm.device)
        if delivery in ("f32", "device"):
            return heat
        from avlmaps_torch.ops import delivery as dlv

        if delivery == "u8":
            return dlv.dequantize_heat_u8(
                dlv.fetch_np(dlv.quantize_heat_u8(heat)))
        if delivery == "topk":
            return dlv.fetch_np(*dlv.topk_peaks(heat, vm.grid_pos))
        if delivery == "goal":
            return dlv.fetch_np(dlv.fused_goal_pick([heat], vm.grid_pos)[0])
        raise ValueError(f"unknown delivery format {delivery!r}")

    # -- area (reference avlmap.py:78-109) ---------------------------------

    def index_area_2d(self, area_name: str, decay_rate: float = 0.1,
                      delivery: str = "f32"):
        """Per-pose CLIP scores splatted as radial decays, max-composited.

        The pose -> map-cell conversion stays on the host (per pose); the
        decay stack and the min-max normalisation run on the device
        (ops/heatmap.decayed_point_heatmap_2d).  ``delivery``: "f32"
        (default, host array) / "u8" (1-byte wire format) / "device" (the
        tensor left on the device)."""
        shape = self.vlmap.occupied_ids.shape[:2]
        scores = self.area_map.index_map(area_name, with_init_cat=False)
        rng = scores.max() - scores.min()
        scores = (scores - scores.min()) / (rng if rng > 0 else 1.0)

        seeds, confs = [], []
        for i, tf_hab in enumerate(self.area_map.robot_pose_list):
            self.dataloader.from_habitat_tf(np.asarray(tf_hab))
            row, col, _ = self.dataloader.to_full_map_pose()
            if not (0 <= row < shape[0] and 0 <= col < shape[1]):
                continue
            seeds.append(np.array([[row, col]], np.float32))
            confs.append(float(scores[i]))

        return self._deliver_2d(decayed_point_heatmap_2d(
            shape, seeds, confs, decay_rate, combine="max", normalize=True,
            as_device=delivery != "f32", device=self.vlmap.device), delivery)

    @staticmethod
    def _deliver_2d(heat, delivery: str):
        if delivery in ("f32", "device"):
            return heat
        from avlmaps_torch.ops import delivery as dlv

        if delivery == "u8":
            return dlv.dequantize_heat_u8(
                dlv.fetch_np(dlv.quantize_heat_u8(heat)))
        raise ValueError(f"unknown delivery format {delivery!r}")

    def index_area(self, area_name: str,
                   decay_rate: float = 0.1) -> np.ndarray:
        heatmap_2d = self.index_area_2d(area_name, decay_rate)
        return lift_2d_to_3d(heatmap_2d, self.vlmap.grid_pos)

    # -- sound (reference avlmap.py:111-144) --------------------------------

    def index_sound_2d(self, sound_name: str, decay_rate: float = 0.01,
                       delivery: str = "f32"):
        """Per-event confidence decays from the event's pose track, summed.

        Each event's seed track (its min radial distance is the
        multi-seed EDT), the sum composite and the min-max normalisation
        run on the device (ops/heatmap.decayed_point_heatmap_2d).
        ``delivery`` as in :meth:`index_area_2d`."""
        probs, locations_list = \
            self.sound_map.get_distribution_and_locations(sound_name)
        shape = self.vlmap.occupied_ids.shape[:2]
        tracks, confs = [], []
        for loc_i, locations in enumerate(locations_list):
            seeds = []
            for location in locations:
                tf_hab = np.eye(4)
                tf_hab[:3, 3] = location
                self.dataloader.from_habitat_tf(tf_hab)
                row, col, _ = self.dataloader.to_full_map_pose()
                if 0 <= row < shape[0] and 0 <= col < shape[1]:
                    seeds.append((row, col))
            if not seeds:
                continue
            tracks.append(np.asarray(seeds, np.float32))
            confs.append(float(probs[loc_i]))

        return self._deliver_2d(decayed_point_heatmap_2d(
            shape, tracks, confs, decay_rate, combine="sum", normalize=True,
            as_device=delivery != "f32", device=self.vlmap.device), delivery)

    def index_sound(self, sound_name: str,
                    decay_rate: float = 0.01) -> np.ndarray:
        heatmap_2d = self.index_sound_2d(sound_name, decay_rate)
        return lift_2d_to_3d(heatmap_2d, self.vlmap.grid_pos)

    # -- image (reference avlmap.py:146-163) --------------------------------

    def index_image(self, image: np.ndarray,
                    query_cam_intrinsics: Optional[np.ndarray] = None,
                    decay_rate: float = 0.01):
        raise _not_ported("index_image (the visual map)", "item 6")

    # -- visualization helper (reference avlmap.py:57-66) -----------------

    def heatmap_rgb(self, heatmap: np.ndarray,
                    transparency: float = 0.5) -> np.ndarray:
        """Blend a [0, 1] heatmap with the voxel colours (JET)."""
        import cv2

        sim = (np.asarray(heatmap) * 255).astype(np.uint8)
        heat = cv2.applyColorMap(sim, cv2.COLORMAP_JET)
        heat = heat.reshape(-1, 3)[:, ::-1].astype(np.float32)
        return heat * transparency + self.vlmap.grid_rgb * (1 - transparency)
