"""CLIP in PyTorch: text and vision towers, tokenizer, weight bridges and
the feature APIs (counterpart of ``avlmaps_tpu/models/clip``)."""

from avlmaps_torch.models.clip.features import (MULTIPLE_TEMPLATES,
                                                ClipEncoder)
from avlmaps_torch.models.clip.model import (CLIP_FEAT_DIMS, CLIP_VARIANTS,
                                             Clip, ClipConfig, TextEncoder,
                                             VisionTransformer,
                                             preprocess_images, quick_gelu)
from avlmaps_torch.models.clip.port import (init_params,
                                            load_clip_checkpoint,
                                            params_from_flax)
from avlmaps_torch.models.clip.tokenizer import (CONTEXT_LENGTH,
                                                 VOCAB_SIZE, ClipTokenizer,
                                                 default_tokenizer, tokenize)

__all__ = [
    "CLIP_FEAT_DIMS", "CLIP_VARIANTS", "CONTEXT_LENGTH", "Clip",
    "ClipConfig", "ClipEncoder", "ClipTokenizer", "MULTIPLE_TEMPLATES",
    "TextEncoder", "VOCAB_SIZE", "VisionTransformer", "default_tokenizer",
    "init_params", "load_clip_checkpoint", "params_from_flax",
    "preprocess_images", "quick_gelu", "tokenize",
]
