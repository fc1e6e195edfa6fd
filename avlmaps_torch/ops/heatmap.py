"""Heatmaps: 1 on targets, decaying with the distance elsewhere.

Counterpart of ``avlmaps_tpu/ops/heatmap.py``.  The 2D half (the exact
EDT, the banded 2D heat and the per-event radial decay stacks of the area
and sound queries) sits at the end of the module.  In 3D the reference
loops over every non-target voxel with a full scan of the targets
(avlmaps/utils/visualize_utils.py:29-49, O(N*M)).  Here, as in
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


# ---------------------------------------------------------------------------
# 2D: exact EDT, banded heat, and the per-event decay stacks
# ---------------------------------------------------------------------------

_FAR = 1.0e6  # seed coordinate that lies beyond every grid


def _tensor_on(a, device) -> torch.Tensor:
    """``a`` where it lies if a tensor, else on ``device``."""
    if isinstance(a, torch.Tensor):
        return a
    return to_device(a, resolve_device(device))


def distance_transform_edt(zero_mask: torch.Tensor,
                           row_chunk: int = 16) -> torch.Tensor:
    """Exact EDT: distance from each pixel to the nearest True pixel, i.e.
    ``scipy.ndimage.distance_transform_edt(~zero_mask)``; the counterpart
    of ``avlmaps_tpu``'s ``distance_transform_edt_jax``.

    Pass 1 takes each column's row distance to its nearest zero (capped
    at h + w + 1, as the JAX sweeps are) from running maxima of the zero
    rows above and below; pass 2 is the exact lower envelope
    ``D(i, j)^2 = min_k G(i, k)^2 + (j - k)^2`` as a broadcast min over
    ``row_chunk`` rows at a time.  Every value is an integer below 2^24
    until the square root, so both packages give the same bits."""
    h, w = zero_mask.shape
    dev = zero_mask.device
    big = float(h + w + 1)
    rows = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    neg = torch.tensor(-big * 4, device=dev)
    above = torch.cummax(torch.where(zero_mask, rows, neg), dim=0).values
    below = torch.flip(torch.cummax(torch.flip(
        torch.where(zero_mask, -rows, neg), [0]), dim=0).values, [0])
    g = torch.minimum(rows - above, -below - rows).clamp_(max=big)

    cols = torch.arange(w, device=dev, dtype=torch.float32)
    dx2 = (cols[:, None] - cols[None, :]) ** 2  # (j, k)
    g2 = g * g
    d2 = torch.empty_like(g2)
    for r0 in range(0, h, row_chunk):
        block = g2[r0:r0 + row_chunk]
        d2[r0:r0 + row_chunk] = torch.amin(block[:, None, :] + dx2[None],
                                           dim=-1)
    return torch.sqrt(d2)


def _banded_heat_2d(zero_mask: torch.Tensor, r: int,
                    decay_per_cell: float) -> torch.Tensor:
    """Banded 2D squared EDT + decay: exact wherever the heat is nonzero
    (distances <= r) and clipped to zero beyond, as the full EDT would
    give, at O(cells x band)."""
    d2 = torch.where(zero_mask, 0.0, _INF).float()
    d2 = _banded_axis_pass(d2, r, 0)
    d2 = _banded_axis_pass(d2, r, 1)
    return torch.clamp(1.0 - torch.sqrt(d2) * decay_per_cell, 0.0, 1.0)


def heatmap_from_mask_2d(mask, cell_size: float = 0.05,
                         decay_rate: float = 0.01, as_device: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """2D heatmap via EDT decay (reference get_heatmap_from_mask_2d,
    visualize_utils.py:97-102).  The decay reaches zero at
    ``cell_size / decay_rate`` pixels, so when that band fits the banded
    EDT replaces the full one; the output is the same either way.

    ``mask``: a tensor (used where it lies) or a host array, which goes
    to ``device`` (default ``"cuda"``; raises without a card).  Returns
    host f32, or the tensor with ``as_device=True``."""
    zero = _tensor_on(mask, device) != 0
    decay_per_cell = decay_rate / cell_size
    heat = None
    if decay_rate > 0:
        r = int(np.ceil(1.0 / decay_per_cell)) + 1
        if r <= _DENSE_MAX_BAND:
            heat = _banded_heat_2d(zero, r, float(decay_per_cell))
    if heat is None:
        dists = distance_transform_edt(zero) / cell_size
        heat = torch.clamp(1.0 - dists * decay_rate, min=0.0)
    return heat if as_device else heat.cpu().numpy()


def radial_decay_heatmap(grid_pos, center, decay_rate: float = 0.01,
                         confidence: float = 1.0,
                         device: Union[str, torch.device] = "cuda"
                         ) -> torch.Tensor:
    """Planar radial decay from one map position (reference
    AVLMap.index_image, avlmap.py:146-163): distances use only (row,
    col).  Returns the (N,) tensor on the device of ``grid_pos``."""
    pos = _tensor_on(grid_pos, device)
    c = to_device(center, pos.device, torch.float32)
    d = torch.linalg.vector_norm(pos[:, :2].float() - c[:2], dim=1)
    return torch.clamp(confidence - decay_rate * d, 0.0, 1.0)


def _stacked_decay_scan(tracks, confidences, h: int, w: int,
                        decay_rate: float, combine: str,
                        normalize: bool = False,
                        chunk_bytes: int = 1 << 26) -> torch.Tensor:
    """Per event: the min radial distance over its seed track, the decay
    layer, and the max or sum composite, folded in event order as the JAX
    scan folds them (the sum rounds the same way).

    The JAX package folds one seed at a time into an (h, w) carry; here a
    chunk of seeds is one broadcast min over a (chunk, h, w) block of
    ``(row - r_s)^2 + (col - c_s)^2`` (the same f32 terms in the same
    order; a min is exact in any order), with the row and column terms of
    every seed computed once.  At gs = 1000 a chunk is 16 seeds (64 MB),
    so an event costs three launches per 16 seeds instead of three per
    seed."""
    dev = confidences.device
    rows = torch.arange(h, device=dev, dtype=torch.float32)
    cols = torch.arange(w, device=dev, dtype=torch.float32)
    chunk = max(1, chunk_bytes // (4 * h * w))
    out = torch.zeros((h, w), device=dev)
    for i, seeds in enumerate(tracks):
        dr = (rows[None, :] - seeds[:, 0:1]) ** 2  # (T, h)
        dc = (cols[None, :] - seeds[:, 1:2]) ** 2  # (T, w)
        d2min = None
        for c0 in range(0, seeds.shape[0], chunk):
            d2 = torch.amin(dr[c0:c0 + chunk, :, None]
                            + dc[c0:c0 + chunk, None, :], dim=0)
            d2min = d2 if d2min is None else torch.minimum(d2min, d2)
        dist = torch.sqrt(d2min)
        conf = confidences[i]
        if combine == "max":
            layer = torch.clamp(conf - dist * decay_rate, 0.0, 1.0)
            out = torch.maximum(out, layer)
        else:
            layer = torch.clamp(conf - conf * dist * decay_rate, min=0.0)
            out = out + layer
    if normalize:
        lo, hi = torch.aminmax(out)
        rng = hi - lo
        out = (out - lo) / torch.where(rng > 0, rng, torch.ones_like(rng))
    return out


def decayed_point_heatmap_2d(shape, points_rc, confidences,
                             decay_rate: float, combine: str = "max",
                             normalize: bool = False,
                             as_device: bool = False,
                             device: Union[str, torch.device] = "cuda"):
    """Stack per-event radial-decay maps (reference AVLMap.index_area_2d,
    avlmaps/map/avlmap.py:78-108, and index_sound_2d, :110-144) on
    ``device`` (default ``"cuda"``; raises without a card).

    ``points_rc``: per-event seed tracks, either a flat (E, 2) array (one
    seed per event, the area case) or a list of (T_i, 2) arrays (pose
    tracks, the sound case).  For each event with confidence c the map is
    ``clip(c - dist * decay, 0, 1)`` (``combine="max"``, area) or
    ``max(c - c * dist * decay, 0)`` (``"sum"``, sound), with ``dist`` the
    min radial distance over the event's seeds: each seed map has one
    nonzero pixel, whose EDT is exactly that distance.  ``normalize``
    min-max-normalises on the device.  Returns (h, w) f32, host numpy or
    the tensor with ``as_device=True``.

    The JAX package pads events and seeds to powers of two with far seeds
    and zero confidences so that its compiled program is reused; a padded
    event adds a zero layer and a far seed never wins the min, so the
    result is the same without the padding, and nothing here pads."""
    h, w = int(shape[0]), int(shape[1])
    dev = resolve_device(device)
    tracks = []
    for p in points_rc:
        t = np.atleast_2d(np.asarray(p, np.float32))
        if t.shape[0] == 0:  # all-padding in the JAX package
            t = np.full((1, 2), _FAR, np.float32)
        tracks.append(t)
    if not tracks:
        out = torch.zeros((h, w), device=dev)
    else:
        # one upload for every track; the split makes views
        seeds = to_device(np.concatenate(tracks), dev)
        tracks = torch.split(seeds, [t.shape[0] for t in tracks])
        conf = to_device(np.asarray(confidences, np.float32), dev)
        out = _stacked_decay_scan(tracks, conf, h, w, float(decay_rate),
                                  combine, normalize)
    return out if as_device else out.cpu().numpy()
