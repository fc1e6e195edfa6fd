"""LSeg in PyTorch: ViT backbone, DPT decoder, sliding-window inference and
the weight bridge from the JAX package's variables."""

from avlmaps_torch.models.lseg.model import (LOGIT_SCALE, LSegConfig,
                                             LSegNet,
                                             cast_params_for_inference)
from avlmaps_torch.models.lseg.port import init_params, params_from_flax
from avlmaps_torch.models.lseg.vit import DenseViT, DenseViTConfig, ViTBlock
from avlmaps_torch.models.lseg.window import (
    DEFAULT_SCALES, bilinear_patch_sample, features_at_points,
    multi_scale_features, normalize_image, plan_windows,
    sliding_window_features, whole_canvas_features_at_points)

__all__ = ["DEFAULT_SCALES", "DenseViT", "DenseViTConfig", "LOGIT_SCALE",
           "LSegConfig", "LSegNet", "ViTBlock", "bilinear_patch_sample",
           "cast_params_for_inference", "features_at_points", "init_params",
           "multi_scale_features", "normalize_image", "params_from_flax",
           "plan_windows", "sliding_window_features",
           "whole_canvas_features_at_points"]
