"""Maps: the voxel-map artifact, its builder, the open-vocabulary VLMap,
the area and sound maps, and the AVLMap facade over them."""

from avlmaps_torch.map.area_map import AreaMap
from avlmaps_torch.map.avlmap import AVLMap
from avlmaps_torch.map.map_base import Map
from avlmaps_torch.map.sound_map import SoundMap
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.map.vlmap_builder import VLMapBuilder
from avlmaps_torch.map.voxel_map import SparseVoxelMap, load_3d_map

__all__ = ["AVLMap", "AreaMap", "Map", "SoundMap", "SparseVoxelMap",
           "VLMap", "VLMapBuilder", "load_3d_map"]
