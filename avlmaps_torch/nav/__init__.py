"""Host-side navigation: visibility-graph planning + discrete control
(counterpart of ``avlmaps_tpu/nav``)."""

from avlmaps_torch.nav.controller import DiscreteNavController, NavController
from avlmaps_torch.nav.navigator import Navigator
from avlmaps_torch.nav.visgraph import (VisGraph,
                                       build_visgraph_with_obs_map,
                                       line_clear, plan_to_pos_v2)

__all__ = [
    "VisGraph", "build_visgraph_with_obs_map", "plan_to_pos_v2",
    "line_clear", "Navigator", "NavController", "DiscreteNavController",
]
