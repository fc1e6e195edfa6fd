"""Geometry: pose transforms (numpy), projection and grid ids (tensors)."""

from avlmaps_torch.geometry.grid import (base_pos_to_grid_id,
                                         out_of_range_mask, voxel_linear_id)
from avlmaps_torch.geometry.projection import (apply_mat3,
                                               depth_to_pointcloud,
                                               get_sim_cam_mat,
                                               get_sim_cam_mat_with_fov,
                                               project_points,
                                               transform_points)
from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                               build_base_transform,
                                               pose_vec_to_tf)

__all__ = ["apply_mat3", "base_pos_to_grid_id", "build_base2cam_tf",
           "build_base_transform", "depth_to_pointcloud", "get_sim_cam_mat",
           "get_sim_cam_mat_with_fov", "out_of_range_mask", "pose_vec_to_tf",
           "project_points", "transform_points", "voxel_linear_id"]
