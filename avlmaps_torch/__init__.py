"""avlmaps_torch: AVLMaps in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).  Ported so far: map construction (sliding-window
and multi-scale LSeg), the open-vocabulary object query, the area and
sound queries (AudioCLIP, Wav2CLIP), the image query (SuperPoint,
SuperGlue, NetVLAD, the visual map), the multi-floor build and query, and
the navigation stack, the robot, the tasks and the applications.

Sub-packages mirror ``avlmaps_tpu`` module by module so a reader finds each
counterpart: ``config``, ``geometry``, ``ops`` (kernel wrappers and their
plain PyTorch versions), ``models`` (``lseg``, ``clip``, ``audioclip``,
``wav2clip``, ``superpoint``, ``superglue``, ``netvlad``), ``map``,
``dataloader``, ``pipeline``, ``nav``, ``robot``, ``task``,
``application`` (the CLIs), ``utils``.
Kernel sources live in ``csrc/`` and are built on first use by
``kernels/build.py`` into ``_build/``.

Entry points (``VLMapBuilder``, ``VLMapBuilderMultiFloor``,
``VLMapMultiFloor``, ``LangRobot``, ``HabitatLanguageRobot``, the CLIs'
``--device``, ``LSegNet`` / ``init_params``,
``init_fusion_state``, the frame-step factories, ``ClipEncoder``,
``AudioClipEncoder``, ``Wav2ClipEncoder``, ``SuperPointExtractor``,
``SuperGlueMatcher``, ``NetVLADEncoder``, ``VLMap``, ``AreaMap``,
``SoundMap``, ``VisualMap``, ``AVLMap``, the query factories of
``ops.delivery``) run on ``device="cuda"``
unless the caller passes ``device="cpu"``; without a card they raise rather
than fall back to the CPU.
"""

__all__ = ["config", "geometry", "ops", "models", "map", "dataloader",
           "pipeline", "nav", "robot", "task", "application", "utils",
           "kernels"]
