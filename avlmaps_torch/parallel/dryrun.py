"""One full sharded map-building step at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
the frame transport, the canvas transport and the all-to-all routing on an
``n``-shard mesh, with a tiny16 LSeg of seeded weights.  Runs on the CPU
(``dryrun_multichip(4, devices=["cpu"] * 4)``) or on cards
(``dryrun_multichip(4, devices=["cuda:0"] * 4)``; by default the first
``n`` cards, and it raises when fewer exist).

The tests hold the sharded program to the JAX package, so they need JAX,
which a card machine may not have; this check needs only torch.  It is
the seconds-long bring-up check of a multi-card host (peer copies, each
card's kernel set-up) before a full build:

    python -m avlmaps_torch.parallel.dryrun 4         # the first 4 cards
    python -m avlmaps_torch.parallel.dryrun 4 cuda:0  # 4 shards on one card
    python -m avlmaps_torch.parallel.dryrun 4 cpu
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """One map-building step through each transport and routing on an
    ``n_devices``-shard mesh; raises unless each builds voxels and the
    all-to-all map equals the all-gather one.  Returns the voxel counts."""
    from avlmaps_torch.geometry.projection import get_sim_cam_mat
    from avlmaps_torch.map.vlmap_builder import sample_pixels
    from avlmaps_torch.models.lseg import LSegConfig, LSegNet, init_params
    from avlmaps_torch.parallel.sharded import ShardedFusion, make_mesh

    mesh = make_mesh(n_devices, devices=devices)
    if mesh.size < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {mesh.size}")
    dev = mesh.devices[0]
    gs, cs, vh = 8 * n_devices, 0.1, 8
    h, w = 32, 32
    cfg = LSegConfig.tiny16()
    net = LSegNet(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    net.load_state_dict(init_params(cfg, gen), strict=True)
    net.eval().requires_grad_(False)
    if len(set(mesh.devices)) == 1:
        apply = net
    else:  # one copy of the network on each shard's device
        copies = {d: LSegNet(cfg, device=d) for d in set(mesh.devices)}
        for d, m in copies.items():
            m.load_state_dict(net.state_dict(), strict=True)
            m.eval().requires_grad_(False)
        apply = [copies[d] for d in mesh.devices]

    def fusion(**kw) -> ShardedFusion:
        return ShardedFusion(
            mesh, gs=gs, cs=cs, vh=vh, feat_dim=cfg.out_dim,
            capacity=1024 * n_devices, calib_mat=get_sim_cam_mat(h, w),
            image_hw=(h, w), lseg_apply=apply, base_size=32, crop_size=32,
            **kw)

    b = 2 * n_devices
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.15, 0.7, (b, h, w)).astype(np.float32)
    pose = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    idx = sample_pixels(rng, h, w, 4, 128, b)
    fvalid = np.ones((b,), bool)
    with torch.no_grad():
        frame = fusion()
        frame.step(rgb, depth, pose, idx, fvalid)
        feat, pos, _, occupied, _ = frame.export()
        if feat.shape[0] == 0:
            raise AssertionError("sharded fusion produced no voxels")
        if occupied.shape != (gs, gs, vh):
            raise AssertionError(f"occupied table {occupied.shape}")

        # the lean canvas transport, the production feed
        canvas = fusion(transport="canvas")
        canvas.step(rng.integers(0, 255, (b, h, w, 3)).astype(np.uint8),
                    rng.uniform(150, 700, (b, 128)).astype(np.uint16),
                    rng.integers(0, 255, (b, 128, 3)).astype(np.uint8),
                    pose, idx, fvalid)
        feat_c = canvas.export()[0]
        if feat_c.shape[0] == 0:
            raise AssertionError("canvas-transport sharded fusion empty")

        # owner-routed exchange: identity poses are the worst ownership
        # skew, so slack = n makes the buckets lossless and the map must
        # equal the all-gather one
        a2a = fusion(payload_routing="all_to_all",
                     a2a_slack=float(n_devices))
        a2a.step(rgb, depth, pose, idx, fvalid)
        feat_a, pos_a, _, _, _ = a2a.export()
    if feat_a.shape[0] != feat.shape[0]:
        raise AssertionError(f"all_to_all built {feat_a.shape[0]} voxels, "
                             f"all_gather {feat.shape[0]}")
    k_g, k_a = np.lexsort(pos.T), np.lexsort(pos_a.T)
    np.testing.assert_array_equal(pos[k_g], pos_a[k_a])
    out = {"voxels": int(feat.shape[0]), "canvas_voxels": int(feat_c.shape[0]),
           "shards": mesh.size}
    print(f"dryrun_multichip({n_devices}): ok, {out['voxels']} voxels "
          f"across {mesh.size} shards (+{out['canvas_voxels']} via the "
          "canvas transport; all_to_all routing matches)")
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    where = sys.argv[2] if len(sys.argv) > 2 else None
    dryrun_multichip(n, devices=[where] * n if where else None)
