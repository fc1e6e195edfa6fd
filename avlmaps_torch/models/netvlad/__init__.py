"""NetVLAD in PyTorch: the VGG16 trunk, the VLAD head, the retrieval
encoder and the weight bridges (counterpart of
``avlmaps_tpu/models/netvlad``)."""

from avlmaps_torch.models.netvlad.model import (VGG16_PLAN, NetVLAD,
                                                NetVLADConfig,
                                                NetVLADEncoder, VGGBackbone)
from avlmaps_torch.models.netvlad.port import (init_params,
                                               load_netvlad_encoder,
                                               load_netvlad_mat,
                                               params_from_flax)

__all__ = ["NetVLAD", "NetVLADConfig", "NetVLADEncoder", "VGG16_PLAN",
           "VGGBackbone", "init_params", "load_netvlad_encoder",
           "load_netvlad_mat", "params_from_flax"]
