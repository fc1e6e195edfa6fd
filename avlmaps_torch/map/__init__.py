"""Maps: the voxel-map artifact, its builder, the open-vocabulary VLMap
and the object-query part of AVLMap."""

from avlmaps_torch.map.avlmap import AVLMap
from avlmaps_torch.map.map_base import Map
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.map.vlmap_builder import VLMapBuilder
from avlmaps_torch.map.voxel_map import SparseVoxelMap, load_3d_map

__all__ = ["AVLMap", "Map", "SparseVoxelMap", "VLMap", "VLMapBuilder",
           "load_3d_map"]
