"""Canvas transports: ship only what the device step reads.

Counterpart of the canvas half of ``avlmaps_tpu/pipeline/transport.py``.
The map-building step reads (a) the base_size-resized canvas the
sliding-window LSeg runs on, (b) depth at the ~h*w/100 sampled pixels and
(c) the colour at those pixels, so a :class:`CanvasBatch` carries the
align-corners resized canvas as uint8, the sampled depth as uint16
millimetres, the sampled colour as uint8 and the sample indices -- ~6.4x
fewer bytes than uint8 RGB plus uint16 depth frames.  Depth and colour
values are the frames' own; the canvas is re-quantised to uint8 after the
resize.  A :class:`RawCanvasBatch` carries the canvas and the full-res
uint16 depth plane instead, for the step that samples on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@functools.lru_cache(maxsize=16)
def _axis_plan(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """(lo, hi, frac) gather plan for 1-D align-corners bilinear resize --
    the weights of ops/resize._interp_matrix_align_corners."""
    if n_out == 1 or n_in == 1:
        z = np.zeros(n_out, np.int64)
        return z, z, np.zeros(n_out, np.float32)
    coords = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    lo = np.clip(np.floor(coords), 0, n_in - 1).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (coords - lo).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=16)
def _remap_grids(h: int, w: int, out_h: int,
                 out_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.remap source-coordinate grids for align-corners bilinear."""
    ys = (np.arange(out_h) * ((h - 1) / max(out_h - 1, 1))).astype(np.float32)
    xs = (np.arange(out_w) * ((w - 1) / max(out_w - 1, 1))).astype(np.float32)
    my, mx = np.meshgrid(ys, xs, indexing="ij")
    return mx, my


def resize_canvas_u8(rgb_u8: np.ndarray, out_h: int,
                     out_w: int) -> np.ndarray:
    """Align-corners bilinear resize of (H, W, 3) or (B, H, W, 3) uint8.

    cv2.remap with the align-corners grid (bilinear weights quantised to
    1/32, at most 1 uint8 level off); without cv2, the separable f32
    bilinear with the weights of ops/resize.resize_bilinear_align_corners."""
    squeeze = rgb_u8.ndim == 3
    if squeeze:
        rgb_u8 = rgb_u8[None]
    _, h, w, _ = rgb_u8.shape
    if (h, w) == (out_h, out_w):
        return rgb_u8[0] if squeeze else rgb_u8
    if cv2 is not None:
        mx, my = _remap_grids(h, w, out_h, out_w)
        out = np.stack([cv2.remap(f, mx, my, cv2.INTER_LINEAR)
                        for f in rgb_u8])
        return out[0] if squeeze else out
    ylo, yhi, fy = _axis_plan(h, out_h)
    xlo, xhi, fx = _axis_plan(w, out_w)
    x = rgb_u8.astype(np.float32)
    x = x[:, ylo] * (1.0 - fy)[None, :, None, None] \
        + x[:, yhi] * fy[None, :, None, None]
    x = x[:, :, xlo] * (1.0 - fx)[None, None, :, None] \
        + x[:, :, xhi] * fx[None, None, :, None]
    out = np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return out[0] if squeeze else out


@dataclass
class CanvasBatch:
    """One lean batch (pairs with vlmap_builder.make_frame_step_canvas)."""

    frame_ids: np.ndarray  # (B,) int32, -1 for padding frames
    canvas: np.ndarray  # (B, ch, cw, 3) uint8 resized RGB
    z_mm: np.ndarray  # (B, N) uint16 depth at sampled pixels, millimetres
    rgb_pts: np.ndarray  # (B, N, 3) uint8 colour at sampled pixels
    sample_idx: np.ndarray  # (B, N) int32 flat full-res pixel indices
    pose_tf: np.ndarray  # (B, 4, 4) float32


def make_canvas_transform(sampler: Callable[[int], np.ndarray],
                          canvas_hw: Tuple[int, int]) -> Callable:
    """Loader ``transform``: full-res FrameBatch -> CanvasBatch, on the
    producer thread.  ``sampler(batch_size) -> (B, N) int32`` draws the
    pixel subsample (vlmap_builder.sample_pixels bound to the geometry)."""
    ch, cw = canvas_hw

    def transform(batch) -> CanvasBatch:
        b = batch.depth.shape[0]
        idx = sampler(b)
        z = np.take_along_axis(batch.depth.reshape(b, -1), idx, axis=1)
        z_mm = np.clip(z * 1000.0, 0, 65535).astype(np.uint16)
        rgb_pts = np.take_along_axis(batch.rgb.reshape(b, -1, 3),
                                     idx[..., None], axis=1)
        return CanvasBatch(
            frame_ids=batch.frame_ids,
            canvas=resize_canvas_u8(batch.rgb, ch, cw),
            z_mm=z_mm,
            rgb_pts=rgb_pts.astype(np.uint8),
            sample_idx=idx.astype(np.int32),
            pose_tf=batch.pose_tf,
        )

    return transform


@dataclass
class RawCanvasBatch:
    """The device-sampling transport (pairs with vlmap_builder.
    make_frame_step_device_sampled): the resized canvas plus the full-res
    uint16-mm depth plane, with no host-side sampling or per-point gathers;
    from a packed scene it is a pure memmap copy."""

    frame_ids: np.ndarray  # (B,) int32, -1 for padding frames
    canvas: np.ndarray  # (B, ch, cw, 3) uint8 resized RGB
    depth_mm: np.ndarray  # (B, H, W) uint16 full-res depth, millimetres
    pose_tf: np.ndarray  # (B, 4, 4) float32


def make_raw_canvas_transform(canvas_hw: Tuple[int, int]) -> Callable:
    """Loader ``transform`` for the device-sampling step: resize the canvas,
    quantise depth to uint16 mm, ship both (no sampling)."""
    ch, cw = canvas_hw

    def transform(batch) -> RawCanvasBatch:
        return RawCanvasBatch(
            frame_ids=batch.frame_ids,
            canvas=resize_canvas_u8(batch.rgb, ch, cw),
            depth_mm=np.clip(batch.depth * 1000.0, 0,
                             65535).astype(np.uint16),
            pose_tf=batch.pose_tf,
        )

    return transform
