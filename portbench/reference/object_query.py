"""The object query's answer, computed plainly (AVLMaps ``vlmap.py``
``index_map`` and ``visualize_utils.py``'s 3D heat).

A voxel is the query's when, among the query word and the resident
categories (query first), the cosine of its feature is highest for the
query (ties to the first).  Its heat is 1 on the query's voxels and
``1 - d * decay / cs`` elsewhere, clipped to [0, 1], with d the
Euclidean distance in cells to the nearest of them (the reference's
unit quirk: cells divided by the cell size again).  The goal is the
first voxel of highest heat, the top k the k highest, equal heats in
voxel order.

Cosines are in f64.  The heat scans every lattice offset closer than
where it reaches 0, so it is exact and independent of any banded or
separable transform.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference.precision import Precision


def cosines(feats: torch.Tensor, text: torch.Tensor, p: Precision,
            chunk: int = 131072) -> torch.Tensor:
    """(N, C) cosines of map rows and text rows: f64 for ``"f32"``, the
    precision's products otherwise."""
    out = []
    with p.products():
        for s in range(0, feats.shape[0], chunk):
            f = feats[s:s + chunk]
            if p.name == "f32":
                f = f.double()
                t = text.double()
            else:
                f, t = f.float(), text.float()
            f = f / f.norm(dim=1, keepdim=True).clamp(min=1e-30)
            t = t / t.norm(dim=1, keepdim=True).clamp(min=1e-30)
            out.append((p.q(f) @ p.q(t).T).double())
    return torch.cat(out)


def margins(cos: torch.Tensor, query: int) -> torch.Tensor:
    """Query cosine minus the best other category's, (N,) f64: the voxel
    is the query's when it is >= 0."""
    others = cos.clone()
    others[:, query] = float("-inf")
    return cos[:, query] - others.max(dim=1).values


def heat(pos: torch.Tensor, mask: torch.Tensor, dims: Sequence[int],
         decay_per_cell: float) -> torch.Tensor:
    """(N,) f32 heat of voxels at integer cells ``pos`` given the query's
    voxels ``mask``."""
    x, y, z = (int(d) for d in dims)
    grid = torch.zeros(x * y * z, dtype=torch.bool, device=pos.device)
    lin = (pos[:, 0] * y + pos[:, 1]) * z + pos[:, 2]
    grid[lin[mask]] = True
    reach = int(1.0 / decay_per_cell)  # heat is 0 from here on
    d2 = torch.full((pos.shape[0],), float("inf"), device=pos.device,
                    dtype=torch.float64)
    span = range(-reach, reach + 1)
    for dx in span:
        for dy in span:
            for dz in span:
                r2 = dx * dx + dy * dy + dz * dz
                if r2 == 0 or r2 * decay_per_cell ** 2 >= 1.0:
                    continue
                q = pos + torch.tensor([dx, dy, dz], device=pos.device)
                inb = ((q[:, 0] >= 0) & (q[:, 0] < x) & (q[:, 1] >= 0)
                       & (q[:, 1] < y) & (q[:, 2] >= 0) & (q[:, 2] < z))
                ql = ((q[:, 0] * y + q[:, 1]) * z + q[:, 2]) \
                    .clamp(0, x * y * z - 1)
                hit = inb & grid[ql]
                d2 = torch.where(hit, torch.clamp(d2, max=float(r2)), d2)
    h = torch.clamp(1.0 - torch.sqrt(d2.float()) * decay_per_cell, 0.0, 1.0)
    return torch.where(mask, torch.ones_like(h), h)


def delivery(h: torch.Tensor, pos: torch.Tensor, k: int) -> Dict:
    """Goal (first highest) and the top k (equal heats in voxel order)."""
    order = torch.sort(h, descending=True, stable=True).indices[:k]
    return {"goal_pos": pos[order[0]], "topk_vals": h[order],
            "topk_pos": pos[order]}
