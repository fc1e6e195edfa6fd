"""A seeded served map: voxels on the surfaces of a building, features
clustered around their category's text feature.

The building fills the grid's footprint with rooms of 5 m: a floor, walls
of the grid's full height on the room lines, and boxes of furniture on
the floor (top and sides).  Floor voxels are ``floor``, wall voxels
``wall``, a box's voxels one other category drawn per box.  ``voxels`` of
all those surface voxels are kept, drawn at random.  A voxel's feature is
its category's text prototype plus noise; a ``boundary_share`` of voxels
mixes in a second category's prototype with a uniform weight, as a built
map averages pixels across object borders, so some voxels sit near the
tie between two categories.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def _surfaces(dims, categories: Sequence[str], gen: torch.Generator,
              dev) -> Dict[str, torch.Tensor]:
    x, y, z = dims
    room = max(x // 10, 8)
    m = room // 2
    i64 = torch.int64
    rr = torch.arange(m, x - m, device=dev)
    cc = torch.arange(m, y - m, device=dev)
    fr, fc = torch.meshgrid(rr, cc, indexing="ij")
    floor = torch.stack([fr.flatten(), fc.flatten(),
                         torch.zeros_like(fr.flatten())], 1)
    hh = torch.arange(z, device=dev)
    walls = []
    for a in range(m, x - m + 1, room):
        g1, g2 = torch.meshgrid(cc, hh, indexing="ij")
        walls.append(torch.stack([torch.full_like(g1.flatten(), a),
                                  g1.flatten(), g2.flatten()], 1))
    for b in range(m, y - m + 1, room):
        g1, g2 = torch.meshgrid(rr, hh, indexing="ij")
        walls.append(torch.stack([g1.flatten(), torch.full_like(
            g1.flatten(), b), g2.flatten()], 1))
    walls = torch.cat(walls).clamp(max=torch.tensor([x - 1, y - 1, z - 1],
                                                    device=dev))
    others = [i for i, c in enumerate(categories)
              if c not in ("floor", "wall")]
    n_box = (x // room) * (y // room) * 5
    sizes = torch.randint(2, max(room // 3, 3), (n_box, 3), generator=gen,
                          device=dev)
    sizes[:, 2] = torch.clamp(sizes[:, 2], max=z - 2)
    corner = torch.stack([
        torch.randint(m + 1, x - m - 1, (n_box,), generator=gen, device=dev),
        torch.randint(m + 1, y - m - 1, (n_box,), generator=gen, device=dev),
        torch.ones(n_box, dtype=i64, device=dev)], 1)
    box_cat = torch.tensor(others, device=dev)[torch.randint(
        0, len(others), (n_box,), generator=gen, device=dev)]
    boxes, box_labels = [], []
    for i in range(n_box):
        sx, sy, sz = (int(v) for v in sizes[i])
        ox, oy, _ = (int(v) for v in corner[i])
        g = torch.stack(torch.meshgrid(
            torch.arange(sx, device=dev), torch.arange(sy, device=dev),
            torch.arange(sz, device=dev), indexing="ij"), -1).reshape(-1, 3)
        shell = ((g[:, 0] == 0) | (g[:, 0] == sx - 1) | (g[:, 1] == 0)
                 | (g[:, 1] == sy - 1) | (g[:, 2] == sz - 1))
        v = g[shell] + torch.tensor([ox, oy, 1], device=dev)
        boxes.append(v)
        box_labels.append(torch.full((v.shape[0],), int(box_cat[i]),
                                     device=dev))
    pos = torch.cat([torch.cat(boxes), walls, floor])
    lab = torch.cat([torch.cat(box_labels),
                     torch.full((walls.shape[0],), categories.index("wall"),
                                device=dev),
                     torch.full((floor.shape[0],), categories.index("floor"),
                                device=dev)])
    keep = ((pos[:, 0] < x) & (pos[:, 1] < y) & (pos[:, 2] < z))
    pos, lab = pos[keep], lab[keep]
    lin = (pos[:, 0] * y + pos[:, 1]) * z + pos[:, 2]
    # one voxel per cell: furniture over walls over floor
    uniq, inv = torch.unique(lin, return_inverse=True)
    first = torch.full((uniq.shape[0],), pos.shape[0], device=dev)
    first.scatter_reduce_(0, inv, torch.arange(pos.shape[0], device=dev),
                          reduce="amin")
    return {"pos": pos[first], "label": lab[first]}


def make_map(p: Dict, categories: Sequence[str], prototypes: torch.Tensor,
             seed: int, device) -> Dict[str, torch.Tensor]:
    """``pos`` (N, 3) int32 cells, ``feat`` (N, D) f32, ``label`` (N,)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 1)
    dims = tuple(p["grid"])
    s = _surfaces(dims, categories, gen, dev)
    n_all = s["pos"].shape[0]
    n = min(int(p["voxels"]), n_all)
    pick = torch.randperm(n_all, generator=gen, device=dev)[:n]
    pick = pick.sort().values
    pos, lab = s["pos"][pick], s["label"][pick]
    proto = prototypes.float()
    proto = proto / proto.norm(dim=1, keepdim=True)
    c = proto.shape[0]
    dist = torch.cdist(proto, proto) + torch.eye(c, device=dev) * 1e9
    sigma = float(p["noise"]) * float(dist.min()) / proto.shape[1] ** 0.5
    feat = proto[lab].clone()
    mix = torch.rand(n, generator=gen, device=dev) < p["boundary_share"]
    other = (lab + torch.randint(1, c, (n,), generator=gen, device=dev)) % c
    a = torch.rand(n, generator=gen, device=dev)[:, None]
    feat = torch.where(mix[:, None], a * feat + (1 - a) * proto[other], feat)
    feat += sigma * torch.randn(feat.shape, generator=gen, device=dev)
    return {"pos": pos.to(torch.int32), "feat": feat.contiguous(),
            "label": lab}
