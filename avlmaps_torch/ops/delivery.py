"""Lean query delivery: quantised heat, top-k peaks, the goal pick on the
device, and the serving query.

Counterpart of ``avlmaps_tpu/ops/delivery.py``.  The reference-shaped
result of an object query is a raw (N,) f32 heatmap (4 MB at N = 1e6
voxels), but its consumers never need f32 density: the robot's goal is one
argmax over (a product of) heatmaps (reference
habitat_lang_robot.py:357-430) and the visualiser quantises to a u8
colormap (visualize_utils.py:59-74).  Three wire formats, leanest first:

* ``goal`` -- cross-modal product + argmax on the device; the host fetches
  one (row, col, height) coordinate;
* ``topk`` -- the k highest-heat voxels and their positions;
* ``u8``   -- the density field quantised to 1/255 steps (heat lies in
  [0, 1]), dequantised to f32 on the host.

``make_text_object_query`` is the serving query as one Python function:
CLIP template encode -> K7 score + argmax -> banded dense 3D EDT heat ->
delivery heads.  Its device work makes no host synchronisation before the
caller fetches (the JAX version is one dispatch).  Top-k orders equal
values lowest index first, as ``jax.lax.top_k`` does (``torch.topk`` does
not), by a stable descending sort.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.models.clip.features import MULTIPLE_TEMPLATES
from avlmaps_torch.ops.heatmap import _dense_banded_heat, band_and_dims
from avlmaps_torch.ops.similarity import score_argmax
from avlmaps_torch.utils.device import resolve_device, to_device

__all__ = [
    "quantize_heat_u8", "dequantize_heat_u8", "topk_peaks",
    "fused_goal_pick", "make_object_query", "make_text_object_query",
    "copy_to_host_async", "fetch_np",
]


def quantize_heat_u8(heat: torch.Tensor) -> torch.Tensor:
    """[0, 1] float heat -> u8 in 1/255 steps (round half to even, as
    ``jnp.round``)."""
    return torch.round(torch.clamp(heat, 0.0, 1.0) * 255.0).to(torch.uint8)


def dequantize_heat_u8(u8) -> np.ndarray:
    """Host-side inverse: u8 payload -> f32 in [0, 1]."""
    return np.asarray(u8, np.float32) / np.float32(255.0)


def _stable_topk(heat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, equal values lowest index first
    (``jax.lax.top_k``'s order)."""
    return torch.sort(heat, descending=True, stable=True).indices[:k]


def topk_peaks(heat: torch.Tensor, grid_pos, k: int = 64):
    """(k,) top heat values and their (k, 3) voxel positions, on the
    heat's device."""
    idx = _stable_topk(heat, k)
    pos = to_device(grid_pos, heat.device)
    return heat.index_select(0, idx), pos.index_select(0, idx)


def fused_goal_pick(heats: Sequence, grid_pos):
    """Cross-modal fusion + goal argmax on the device (reference
    get_map_3d x get_major_map_3d -> get_max_pos_3d,
    habitat_lang_robot.py:357-430).

    ``heats``: per-modality (N,) heat tensors (or host arrays, which go to
    the first tensor's device).  Returns ((3,) position, () heat) as
    tensors on that device.  Ties go to the first voxel, as ``np.argmax``
    on the host-fused product."""
    dev = next((h.device for h in heats if isinstance(h, torch.Tensor)),
               torch.device("cpu"))
    fused = torch.stack([to_device(h, dev, torch.float32)
                         for h in heats]).prod(dim=0)
    idx = torch.argmax(fused).view(1)  # an index tensor: no host sync
    pos = to_device(grid_pos, dev)
    return pos.index_select(0, idx)[0], fused.index_select(0, idx)[0]


def copy_to_host_async(*arrays) -> Tuple[list, object]:
    """Start a device->host copy of every tensor into pinned memory and
    return (host tensors, CUDA event or None) without waiting: after
    ``event.synchronize()`` the host tensors hold the values.  Host
    arrays and CPU tensors pass through."""
    out, event = [], None
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            out.append(host)
        else:
            out.append(a)
    if len(out) and any(h is not a for h, a in zip(out, arrays)):
        event = torch.cuda.Event()
        event.record()
    return out, event


def fetch_np(*arrays):
    """Fetch device tensors to host numpy: every copy is started before
    the one wait, so a multi-payload delivery overlaps its transfers."""
    host, event = copy_to_host_async(*arrays)
    if event is not None:
        event.synchronize()
    out = tuple(h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
                for h in host)
    return out[0] if len(out) == 1 else out


def _object_query_program(feats: torch.Tensor, text: torch.Tensor,
                          coords: torch.Tensor, dims, r: int,
                          decay_per_cell: float, k: int, with_u8: bool,
                          with_topk: bool) -> Dict[str, torch.Tensor]:
    """K7 score + argmax -> category-0 mask -> banded dense 3D EDT heat ->
    delivery heads (the JAX package's ``_object_query_program``)."""
    with torch.profiler.record_function("query.score_argmax"):
        mask = score_argmax(feats, text, normalize_map=True,
                            normalize_text=True) == 0
    heat = _dense_banded_heat(coords, mask, dims, r, decay_per_cell)
    with torch.profiler.record_function("query.delivery"):
        goal = torch.argmax(heat).view(1)
        out = {"goal_pos": coords.index_select(0, goal)[0], "heat": heat}
        if with_u8:
            out["heat_u8"] = torch.round(heat * 255.0).to(torch.uint8)
    if with_topk:
        with torch.profiler.record_function("query.topk"):
            idx = _stable_topk(heat, k)
            out["topk_vals"] = heat.index_select(0, idx)
            out["topk_pos"] = coords.index_select(0, idx)
    return out


def make_text_object_query(clip_encoder, grid_shape,
                           cell_size: float = 0.05,
                           decay_rate: float = 0.01, k: int = 64,
                           with_u8: bool = False, with_topk: bool = True,
                           device: Union[str, torch.device] = "cuda"):
    """The serving query, text encode included: CLIP-encode the query's
    template ensemble -> prepend it to the resident category matrix -> K7
    -> banded dense EDT heat -> goal / top-k (/ u8) heads.

    Returns ``query(text, map_feats, grid_pos, other_text_feats) -> dict``
    of tensors on ``device`` (default ``"cuda"``; raises without a card),
    the encoder's device.  ``other_text_feats`` is the (C-1, D)
    pre-encoded category matrix the query competes against (reference
    init_categories semantics, vlmap.py:92-125; the query is category 0).
    ``grid_pos`` must be integer cells inside ``grid_shape``.  Tokenising
    stays on the host and the ids go up through pinned memory, so with
    ``map_feats``, ``grid_pos`` (int32) and ``other_text_feats`` already
    on the device the query makes no host synchronisation.
    """
    dev = resolve_device(device)
    if clip_encoder.device != dev:
        raise ValueError(f"the CLIP encoder lives on {clip_encoder.device}, "
                         f"the query on {dev}")
    decay_per_cell = float(decay_rate) / float(cell_size)
    r, dims = band_and_dims(grid_shape, decay_per_cell)

    def query(text: str, map_feats, grid_pos, other_text_feats):
        with torch.profiler.record_function("query.text_encode"):
            with torch.profiler.record_function("query.tokenize"):
                tokens = clip_encoder.device_tokens(
                    [t.format(text) for t in MULTIPLE_TEMPLATES])
            query_feat = clip_encoder.encode_templates(tokens)
            feats_t = torch.cat([query_feat, to_device(
                other_text_feats, dev, torch.float32)])
        return _object_query_program(
            to_device(map_feats, dev, torch.float32), feats_t,
            to_device(grid_pos, dev, torch.int32), dims, r, decay_per_cell,
            k, with_u8, with_topk)

    return query


def make_object_query(grid_shape, cell_size: float = 0.05,
                      decay_rate: float = 0.01, k: int = 64,
                      with_u8: bool = True, with_topk: bool = True,
                      device: Union[str, torch.device] = "cuda"):
    """The object query for a fixed map layout, from pre-encoded text.

    Returns ``query(map_feats, text_feats, grid_pos) -> dict`` of tensors
    on ``device`` (default ``"cuda"``; raises without a card): ``heat``
    (N,) f32, ``goal_pos`` (3,) int32, and the optional ``heat_u8`` and
    ``topk_vals`` + ``topk_pos`` heads.  ``grid_pos`` must be integer
    voxel cells inside ``grid_shape``; the band radius comes from the
    decay clip as in ``heatmap_from_mask_3d``."""
    dev = resolve_device(device)
    decay_per_cell = float(decay_rate) / float(cell_size)
    r, dims = band_and_dims(grid_shape, decay_per_cell)

    def query(map_feats, text_feats, grid_pos):
        return _object_query_program(
            to_device(map_feats, dev, torch.float32),
            to_device(text_feats, dev, torch.float32),
            to_device(grid_pos, dev, torch.int32), dims, r, decay_per_cell,
            k, with_u8, with_topk)

    return query
