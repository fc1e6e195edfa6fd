"""Robot API: language primitives + simulator bindings (counterpart of
``avlmaps_tpu/robot``)."""

from avlmaps_torch.robot.habitat_lang_robot import HabitatLanguageRobot
from avlmaps_torch.robot.lang_robot import LangRobot
from avlmaps_torch.robot.sim import (HABITAT_AVAILABLE, HabitatSimulator,
                                     KinematicSimulator, Simulator)

__all__ = [
    "LangRobot", "HabitatLanguageRobot", "Simulator", "KinematicSimulator",
    "HabitatSimulator", "HABITAT_AVAILABLE",
]
