"""avlmaps_torch: AVLMaps in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).  Ported so far: map construction and the
open-vocabulary object query.

Sub-packages mirror ``avlmaps_tpu`` module by module so a reader finds each
counterpart: ``config``, ``geometry``, ``ops`` (kernel wrappers and their
plain PyTorch versions), ``models/lseg``, ``models/clip``, ``map``,
``pipeline``, ``utils``.
Kernel sources live in ``csrc/`` and are built on first use by
``kernels/build.py`` into ``_build/``.

Entry points (``VLMapBuilder``, ``LSegNet`` / ``init_params``,
``init_fusion_state``, the frame-step factories, ``ClipEncoder``,
``VLMap``, ``AVLMap``, the query factories of ``ops.delivery``) run on
``device="cuda"``
unless the caller passes ``device="cpu"``; without a card they raise rather
than fall back to the CPU.
"""

__all__ = ["config", "geometry", "ops", "models", "map", "pipeline", "utils",
           "kernels"]
