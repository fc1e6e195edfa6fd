"""Multi-device sharding for map construction.

Counterpart of ``avlmaps_tpu/parallel``.  The reference has no distributed
backend (SURVEY.md §2.6: its only device parallelism is an unused
nn.DataParallel).  The design:

* frames are data-parallel across the mesh for the LSeg forward (the
  FLOPs);
* the voxel grid is sharded by top-down rows: each shard owns gs/n rows of
  the occupied table and its own slot arrays (independent allocators, no
  cross-shard sequencing);
* after each shard's point extraction the compact point payload is
  all-gathered (or routed all-to-all to its owner), and every shard fuses
  only the points landing in its row range.

One process drives every shard (``make_mesh``: a list of torch devices,
repeats allowed), as the JAX package drives a ``Mesh`` with ``shard_map``.
"""

from avlmaps_torch.parallel.sharded import (ShardedFusion, export_sharded,
                                            make_mesh, sharded_score_argmax)

__all__ = ["ShardedFusion", "make_mesh", "export_sharded",
           "sharded_score_argmax"]
