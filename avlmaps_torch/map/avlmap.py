"""AVLMap: the facade over the modality maps, with cross-modal heatmaps.

Counterpart of ``avlmaps_tpu/map/avlmap.py`` (reference
avlmaps/map/avlmap.py).  The port has the object query over the voxel
VLMap; the sound, area and visual maps are not ported yet, so the
constructor builds the VLMap alone and every method that needs another
modality raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from avlmaps_torch.config import AVLMapsConfig
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.ops.heatmap import heatmap_from_mask_3d


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to avlmaps_torch yet (ROADMAP.md, Queue 1 "
        f"{item})")


class AVLMap:
    """The object-query part of AVLMap on ``device`` (default ``"cuda"``;
    raises without a card)."""

    def __init__(self, config: AVLMapsConfig, data_dir: str = "",
                 clip_encoder=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        clip_ckpt = getattr(config, "clip_ckpt", "")
        if clip_encoder is None and (clip_ckpt or getattr(
                config.map_config, "clip_variant", "")):
            from avlmaps_torch.models.clip import ClipEncoder

            clip_encoder = (ClipEncoder.from_checkpoint(clip_ckpt,
                                                        device=device)
                            if clip_ckpt else
                            ClipEncoder(config.map_config.clip_variant,
                                        device=device))
        self.vlmap = VLMap(config.map_config, data_dir=data_dir,
                           clip_encoder=clip_encoder,
                           lseg_ckpt=getattr(config, "lseg_ckpt", ""),
                           clip_ckpt=clip_ckpt, device=device)

    # -- lifecycle (reference avlmap.py:38-56) ----------------------------

    def create_map(self, data_dir: Union[Path, str]) -> bool:
        raise _not_ported("AVLMap.create_map (the area, visual and sound "
                          "maps; VLMap.create_map is ported)", "items 12-14")

    def load_map(self, data_dir: Union[Path, str]) -> bool:
        raise _not_ported("AVLMap.load_map (the area, visual and sound maps "
                          "and the habitat dataloader; VLMap.load_map is "
                          "ported)", "items 12-14")

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

    # -- area, sound, image (reference avlmap.py:78-163) --------------------

    def index_area_2d(self, area_name: str, decay_rate: float = 0.1,
                      delivery: str = "f32"):
        raise _not_ported("index_area_2d (the area map)", "item 13")

    def index_area(self, area_name: str, decay_rate: float = 0.1):
        raise _not_ported("index_area (the area map)", "item 13")

    def index_sound_2d(self, sound_name: str, decay_rate: float = 0.01,
                       delivery: str = "f32"):
        raise _not_ported("index_sound_2d (the sound map)", "item 12")

    def index_sound(self, sound_name: str, decay_rate: float = 0.01):
        raise _not_ported("index_sound (the sound map)", "item 12")

    def index_image(self, image: np.ndarray,
                    query_cam_intrinsics: Optional[np.ndarray] = None,
                    decay_rate: float = 0.01):
        raise _not_ported("index_image (the visual map)", "item 14")

    # -- visualization helper (reference avlmap.py:57-66) -----------------

    def heatmap_rgb(self, heatmap: np.ndarray,
                    transparency: float = 0.5) -> np.ndarray:
        """Blend a [0, 1] heatmap with the voxel colours (JET)."""
        import cv2

        sim = (np.asarray(heatmap) * 255).astype(np.uint8)
        heat = cv2.applyColorMap(sim, cv2.COLORMAP_JET)
        heat = heat.reshape(-1, 3)[:, ::-1].astype(np.float32)
        return heat * transparency + self.vlmap.grid_rgb * (1 - transparency)
