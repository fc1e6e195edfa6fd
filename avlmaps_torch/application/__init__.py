"""The port's command-line applications (counterparts of the repository's
``application/`` scripts), run as ``python -m
avlmaps_torch.application.<name>``: ``create_map``,
``generate_obstacle_map`` and ``index_map``.  Each takes ``--device``
(default ``cuda``)."""
