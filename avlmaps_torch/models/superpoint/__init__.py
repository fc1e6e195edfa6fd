"""SuperPoint in PyTorch: the network, fixed-size keypoint selection,
descriptor sampling, the mutual-NN matcher and the weight bridges
(counterpart of ``avlmaps_tpu/models/superpoint``)."""

from avlmaps_torch.models.superpoint.model import (
    SuperPointConfig, SuperPointExtractor, SuperPointNet,
    mutual_nearest_matches, nms_scores, sample_descriptors,
    select_keypoints)
from avlmaps_torch.models.superpoint.port import (
    config_from_state_dict, init_params, load_superpoint_checkpoint,
    params_from_flax, port_superpoint_state_dict)

__all__ = [
    "SuperPointConfig", "SuperPointExtractor", "SuperPointNet",
    "config_from_state_dict", "init_params", "load_superpoint_checkpoint",
    "mutual_nearest_matches", "nms_scores", "params_from_flax",
    "port_superpoint_state_dict", "sample_descriptors", "select_keypoints",
]
