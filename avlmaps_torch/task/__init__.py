"""Navigation tasks + replay evaluation (counterpart of
``avlmaps_tpu/task``)."""

from avlmaps_torch.task.tasks import (HabitatObjectNavigationTask,
                                      HabitatSpatialGoalNavigationTask,
                                      HabitatTask)

__all__ = [
    "HabitatTask", "HabitatObjectNavigationTask",
    "HabitatSpatialGoalNavigationTask",
]
