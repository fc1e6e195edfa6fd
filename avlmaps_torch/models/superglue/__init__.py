"""SuperGlue in PyTorch: the attentional matcher, the masked Sinkhorn,
the decision rule and the weight bridges (counterpart of
``avlmaps_tpu/models/superglue``)."""

from avlmaps_torch.models.superglue.model import (
    NEG, SuperGlueConfig, SuperGlueMatcher, SuperGlueNet,
    log_optimal_transport, match_from_assignment, normalize_keypoints)
from avlmaps_torch.models.superglue.port import (
    config_from_state_dict, init_params, load_superglue_checkpoint,
    params_from_flax, port_superglue_state_dict)

__all__ = [
    "NEG", "SuperGlueConfig", "SuperGlueMatcher", "SuperGlueNet",
    "config_from_state_dict", "init_params", "load_superglue_checkpoint",
    "log_optimal_transport", "match_from_assignment", "normalize_keypoints",
    "params_from_flax", "port_superglue_state_dict",
]
