"""avlmaps_torch: AVLMaps in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).  Ported so far: map construction (sliding-window
and multi-scale LSeg), the open-vocabulary object query, the area and
sound queries (AudioCLIP, Wav2CLIP) and the image query (SuperPoint,
SuperGlue, NetVLAD, the visual map).

Sub-packages mirror ``avlmaps_tpu`` module by module so a reader finds each
counterpart: ``config``, ``geometry``, ``ops`` (kernel wrappers and their
plain PyTorch versions), ``models`` (``lseg``, ``clip``, ``audioclip``,
``wav2clip``, ``superpoint``, ``superglue``, ``netvlad``), ``map``,
``dataloader``, ``pipeline``, ``utils``.
Kernel sources live in ``csrc/`` and are built on first use by
``kernels/build.py`` into ``_build/``.

Entry points (``VLMapBuilder``, ``LSegNet`` / ``init_params``,
``init_fusion_state``, the frame-step factories, ``ClipEncoder``,
``AudioClipEncoder``, ``Wav2ClipEncoder``, ``SuperPointExtractor``,
``SuperGlueMatcher``, ``NetVLADEncoder``, ``VLMap``, ``AreaMap``,
``SoundMap``, ``VisualMap``, ``AVLMap``, the query factories of
``ops.delivery``) run on ``device="cuda"``
unless the caller passes ``device="cpu"``; without a card they raise rather
than fall back to the CPU.
"""

__all__ = ["config", "geometry", "ops", "models", "map", "dataloader",
           "pipeline", "utils", "kernels"]
