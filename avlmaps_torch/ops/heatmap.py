"""3D heatmaps: 1 on target voxels, decaying with the distance elsewhere.

Counterpart of the 3D half of ``avlmaps_tpu/ops/heatmap.py`` (the 2D EDT
and the decay stacks serve the area and sound maps and are not ported
yet).  The reference loops over every non-target voxel with a full scan of
the targets (avlmaps/utils/visualize_utils.py:29-49, O(N*M)).  Here, as in
the JAX package, two exact device paths:

* dense: scatter the targets into the bounding grid, run a banded
  separable squared EDT (one axis at a time; separability keeps it
  exact), gather the decayed heat at every voxel.  Cost O(cells x band),
  whatever the target count.
* direct: compact the targets, then an exact min-distance scan in row
  and target chunks, O(N x M), for any float positions.

Everything is plain torch (the JAX package computes both with XLA).

Unit quirk kept from the reference: ``grid_pos`` is in cells, yet
distances are divided by ``cell_size`` again before the decay
(visualize_utils.py:40,98).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from avlmaps_torch.utils.device import resolve_device, to_device

_INF = 1.0e12  # squared-distance sentinel of the dense EDT


def _min_dist_to_targets(points: torch.Tensor, targets: torch.Tensor,
                         row_chunk: int = 8192,
                         tgt_chunk: int = 1024) -> torch.Tensor:
    """Per-point min Euclidean distance to any target point, (N,) f32.

    The exact f32 difference per coordinate, summed in coordinate order --
    NOT the |a|^2 + |b|^2 - 2ab expansion (``torch.cdist``'s default above
    25 rows), whose f32 cancellation on ~1e6-sized squares of grid
    coordinates costs ~0.3 in d^2."""
    n = points.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    for r0 in range(0, n, row_chunk):
        block = points[r0:r0 + row_chunk]
        dmin = torch.full((block.shape[0],), float("inf"),
                          device=points.device)
        for t0 in range(0, targets.shape[0], tgt_chunk):
            tile = targets[t0:t0 + tgt_chunk]
            d2 = torch.zeros((block.shape[0], tile.shape[0]),
                             device=points.device)
            for k in range(3):
                diff = block[:, k, None] - tile[None, :, k]
                d2 = d2 + diff * diff
            dmin = torch.minimum(dmin, d2.amin(dim=1))
        out[r0:r0 + row_chunk] = torch.sqrt(dmin)
    return out


def _banded_axis_pass(d2: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """One brute-force squared-EDT pass along ``axis``, banded to
    |o| <= r: ``out[i] = min_{|o|<=r} d2[i+o] + o^2`` (out-of-range reads
    are +inf).  Exact for distances <= r; larger ones stay >= r, where the
    heat is clipped to zero anyway.  Offsets +o and -o share o^2, so each
    pair takes one add: min(a + c, b + c) == min(a, b) + c exactly, since
    rounding is monotone."""
    x = d2.shape[axis]
    shape = list(d2.shape)
    shape[axis] = x + 2 * r
    padded = torch.full(shape, _INF, dtype=d2.dtype, device=d2.device)
    padded.narrow(axis, r, x).copy_(d2)
    out = d2.clone()
    tmp = torch.empty_like(d2)
    for o in range(1, r + 1):
        torch.minimum(padded.narrow(axis, r + o, x),
                      padded.narrow(axis, r - o, x), out=tmp)
        tmp.add_(float(o * o))
        torch.minimum(out, tmp, out=out)
    return out


def _dense_banded_heat(coords: torch.Tensor, mask: torch.Tensor, dims,
                       r: int, decay_per_cell: float) -> torch.Tensor:
    """Scatter the targets into a dense (X, Y, Z) grid of squared
    distances, run the banded separable EDT, gather the decayed heat at
    every row.  ``coords``: (N, 3) int lattice cells inside ``dims``;
    ``mask``: (N,) bool targets.  No host synchronisation.

    Non-target rows write to one spare cell past the grid, so the scatter
    needs neither a boolean index (a host sync) nor a drop mode."""
    x, y, z = (int(v) for v in dims)
    cells = x * y * z
    lin = ((coords[:, 0].long() * y + coords[:, 1].long()) * z
           + coords[:, 2].long())
    flat = torch.full((cells + 1,), _INF, device=coords.device)
    with torch.profiler.record_function("query.scatter_min"):
        flat.index_fill_(0, torch.where(mask, lin, cells), 0.0)
    grid = flat[:cells].view(x, y, z)
    for axis in range(3):
        with torch.profiler.record_function(f"query.edt_axis{axis}"):
            grid = _banded_axis_pass(grid, r, axis)
    with torch.profiler.record_function("query.gather_heat"):
        d2 = grid.reshape(-1).index_select(0, lin)
        heat = torch.clamp(1.0 - torch.sqrt(d2) * decay_per_cell, 0.0, 1.0)
        return torch.where(mask, torch.ones_like(heat), heat)


def band_and_dims(grid_shape, decay_per_cell: float):
    """(band radius r, grid dims) for the dense path: the heat reaches 0
    at d * decay_per_cell >= 1, so the EDT must be exact out to
    ceil(1 / decay_per_cell) (+1 for rounding).  Dims are rounded up to
    multiples of 32, as in the JAX package, so both packages' grids have
    one shape."""
    r = int(np.ceil(1.0 / decay_per_cell)) + 1
    dims = tuple(int(-(-int(s) // 32) * 32) for s in grid_shape)
    return r, dims


def _lattice_snap(pos: np.ndarray, cell_size: float):
    """(int coords, lattice unit in input units) when positions sit on an
    integer or cell_size-spaced lattice, else (None, None).  The builder's
    grid_pos are integer cells; metric voxel centres (grid * cs) snap
    too."""
    for unit in (1.0, float(cell_size)):
        scaled = pos / unit
        snapped = np.rint(scaled)
        if np.max(np.abs(scaled - snapped)) < 1e-4:
            return snapped.astype(np.int64), unit
    return None, None


def _mask_stats(coords: torch.Tensor, mask: torch.Tensor):
    """(target count, per-axis min, per-axis max): one host fetch."""
    stats = torch.cat([mask.sum().view(1), coords.amin(0).long(),
                       coords.amax(0).long()]).cpu().numpy()
    return int(stats[0]), stats[1:4], stats[4:7]


# guards of the dense path: the grid's size, and a band the passes beat
# the direct scan with
_DENSE_MAX_CELLS = 1.6e8
_DENSE_MAX_BAND = 256


def heatmap_from_mask_3d(grid_pos, mask, cell_size: float = 0.05,
                         decay_rate: float = 0.01, method: str = "auto",
                         lattice_unit: Optional[float] = None,
                         grid_shape=None, as_device: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """3D heatmap: 1 on target voxels, ``clip(1 - (min_dist / cell_size)
    * decay_rate, 0, 1)`` elsewhere (reference get_heatmap_from_mask_3d,
    visualize_utils.py:29-49).  Returns (N,) f32: host numpy, or the
    tensor on the device with ``as_device=True``.

    ``grid_pos`` and ``mask`` may be tensors (they are used where they
    lie) or host arrays, which go to ``device`` (default ``"cuda"``;
    raises without a card).

    ``method``: "dense" (banded EDT; lattice positions only), "direct"
    (exact scan over the compacted targets; any positions) or "auto",
    which picks by estimated cost.  ``lattice_unit`` (1.0 for integer
    cells, ``cell_size`` for metric voxel centres) declares the lattice
    without the host-side probe; ``grid_shape`` (lattice extents from
    origin 0, e.g. ``occupied_ids.shape``) skips the coordinate min/max.
    With both and ``method="dense"`` the call makes no host
    synchronisation before its result is fetched.
    """
    dev = mask.device if isinstance(mask, torch.Tensor) \
        else resolve_device(device)
    mask_dev = to_device(mask, dev, torch.bool)
    n = int(mask_dev.shape[0])

    def finish(heat):
        return heat if as_device else heat.cpu().numpy()

    def flat(value: float):
        return finish(torch.full((n,), value, device=dev))

    if decay_rate <= 0.0:
        return flat(1.0)

    m = None  # target count, resolved lazily (a host sync on a card)

    def target_count() -> int:
        nonlocal m
        if m is None:
            m = int(mask_dev.sum())
        return m

    if method != "direct":
        pmin = pmax = None
        coords = None
        if lattice_unit is not None:
            unit = float(lattice_unit)
            pos_dev = to_device(grid_pos, dev)
            coords = (pos_dev.to(torch.int32) if unit == 1.0 else
                      torch.round(pos_dev.float() / unit).to(torch.int32))
            if grid_shape is None:
                m, pmin, pmax = _mask_stats(coords, mask_dev)
        else:
            pos_np = (grid_pos.cpu().numpy() if isinstance(
                grid_pos, torch.Tensor) else np.asarray(grid_pos))
            if target_count() == 0:
                # no target voxels: zero heat everywhere (the decay limit;
                # the reference would crash on an empty argmin)
                return flat(0.0)
            coords, unit = _lattice_snap(pos_np, cell_size)
            if coords is None and method == "dense":
                raise ValueError("method='dense' needs lattice positions")
            if coords is not None and grid_shape is None:
                pmin, pmax = coords.min(axis=0), coords.max(axis=0)
        if grid_shape is not None and coords is not None:
            pmin = np.zeros(3, np.int64)
            pmax = np.asarray(grid_shape, np.int64) - 1
        if pmin is not None:
            decay_per_cell = decay_rate * unit / cell_size
            r, dims = band_and_dims(pmax - pmin + 1, decay_per_cell)
            cells = float(np.prod([float(d) for d in dims]))
            ok = r <= _DENSE_MAX_BAND and cells <= _DENSE_MAX_CELLS
            if method == "dense":
                pick_dense = True
            elif not ok:
                pick_dense = False
            else:
                # Cost model carried over from the JAX package, where its
                # constants were fitted on a TPU; they are not measured on
                # a GPU.  They only steer a choice between two exact paths:
                # dense pays a per-row scatter + gather plus the banded
                # passes, direct pays the target compaction plus the scan,
                # flat through one 1024-target tile and linear beyond.
                cap = 1 << max(target_count() - 1, 127).bit_length()
                est_dense = n * 2.2e-5 + cells * (2 * r + 1) * 3 * 1e-8
                est_direct = (n * 1.9e-5
                              + n * max(cap - 1024, 0) * 1.9e-9)
                pick_dense = est_dense < est_direct
            if pick_dense:
                if m == 0:  # only reachable when m was resolved above
                    return flat(0.0)
                coords = to_device(coords, dev, torch.int32) \
                    - to_device(pmin, dev, torch.int32)
                return finish(_dense_banded_heat(coords, mask_dev, dims, r,
                                                 float(decay_per_cell)))

    # direct path: compact the targets (a host sync), then the exact scan
    if target_count() == 0:
        return flat(0.0)
    pos_dev = to_device(grid_pos, dev, torch.float32)
    targets = pos_dev[mask_dev]
    dists = _min_dist_to_targets(pos_dev, targets) / cell_size
    heat = torch.clamp(1.0 - dists * decay_rate, 0.0, 1.0)
    return finish(torch.where(mask_dev, torch.ones_like(heat), heat))
