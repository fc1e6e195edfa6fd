"""AudioCLIP in PyTorch: the ESResNeXt-FBSP audio tower, the RN50 image
tower, the joint model and its weight bridges (counterpart of
``avlmaps_tpu/models/audioclip``)."""

from avlmaps_torch.models.audioclip.audioclip import (AudioClip,
                                                      AudioClipConfig,
                                                      AudioClipEncoder,
                                                      full_f32)
from avlmaps_torch.models.audioclip.esresnet import (Attention2d,
                                                     Bottleneck,
                                                     ESResNeXtConfig,
                                                     ESResNeXtFBSP,
                                                     FrozenBatchNorm)
from avlmaps_torch.models.audioclip.fbsp import (blackmanharris_window,
                                                 fbsp_apply, fbsp_weights,
                                                 frame_signal, scale_signal)
from avlmaps_torch.models.audioclip.modified_resnet import (
    ModifiedResNet, ModifiedResNetConfig)

__all__ = [
    "Attention2d", "AudioClip", "AudioClipConfig", "AudioClipEncoder",
    "Bottleneck", "ESResNeXtConfig", "ESResNeXtFBSP", "FrozenBatchNorm",
    "ModifiedResNet", "ModifiedResNetConfig", "blackmanharris_window",
    "fbsp_apply", "fbsp_weights", "frame_signal", "full_f32",
    "scale_signal",
]
