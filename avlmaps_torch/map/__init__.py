"""Maps: the voxel-map artifact, its builders (single- and multi-floor),
the open-vocabulary VLMap and VLMapMultiFloor, the area, sound and visual
maps, and the AVLMap facade over them."""

from avlmaps_torch.map.area_map import AreaMap
from avlmaps_torch.map.avlmap import AVLMap
from avlmaps_torch.map.map_base import Map
from avlmaps_torch.map.sound_map import SoundMap
from avlmaps_torch.map.visual_map import VisualMap
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.map.vlmap_builder import VLMapBuilder
from avlmaps_torch.map.vlmap_builder_multi_floor import (
    VLMapBuilderMultiFloor, VLMapMultiFloor)
from avlmaps_torch.map.voxel_map import SparseVoxelMap, load_3d_map

__all__ = ["AVLMap", "AreaMap", "Map", "SoundMap", "SparseVoxelMap",
           "VLMap", "VLMapBuilder", "VLMapBuilderMultiFloor",
           "VLMapMultiFloor", "VisualMap", "load_3d_map"]
