"""Sliding-window LSeg inference as one batched forward.

Counterpart of ``avlmaps_tpu/models/lseg/window.py`` (reference:
avlmaps/utils/lseg_utils.py:20-119).  All crops of the static window grid
run as ONE forward (the window axis folds into the batch axis) and the
overlap average is a count-normalised sum.  ``apply_fn(images)`` is the
pixel-feature network, e.g. ``lambda x: net(x, upsample=False)``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from avlmaps_torch.ops.resize import resize_bilinear_align_corners

NORM_MEAN = (0.5, 0.5, 0.5)
NORM_STD = (0.5, 0.5, 0.5)


def normalize_image(rgb_uint8: np.ndarray) -> np.ndarray:
    """HWC uint8 -> normalised float32 (reference lseg transform,
    vlmap_builder.py:255-261: ToTensor + Normalize(0.5, 0.5))."""
    img = rgb_uint8.astype(np.float32) / 255.0
    return (img - np.asarray(NORM_MEAN)) / np.asarray(NORM_STD)


def plan_windows(h: int, w: int, base_size: int = 520, crop_size: int = 480,
                 stride_rate: float = 2.0 / 3.0):
    """Static sliding-window plan for an (h, w) input: (resized_h,
    resized_w, padded_h, padded_w, crops), crops as (h0, h1, w0, w1) in
    padded coords (reference lseg_utils.py:42-52, 69-76)."""
    stride = int(crop_size * stride_rate)
    if h > w:
        height, width = base_size, int(1.0 * w * base_size / h + 0.5)
    else:
        width, height = base_size, int(1.0 * h * base_size / w + 0.5)
    ph, pw = max(height, crop_size), max(width, crop_size)
    crops: List[Tuple[int, int, int, int]] = []
    h_grids = int(math.ceil(1.0 * (ph - crop_size) / stride)) + 1
    w_grids = int(math.ceil(1.0 * (pw - crop_size) / stride)) + 1
    for idh in range(h_grids):
        for idw in range(w_grids):
            h0, w0 = idh * stride, idw * stride
            h1, w1 = min(h0 + crop_size, ph), min(w0 + crop_size, pw)
            crops.append((h0, h1, w0, w1))
    return height, width, ph, pw, crops


def _pad_value() -> np.ndarray:
    """-mean/std: the normalised zero pixel (reference pad_image)."""
    return -np.asarray(NORM_MEAN, np.float32) / np.asarray(NORM_STD,
                                                           np.float32)


def _pad_canvas(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(B, h, w, 3) -> (B, ph, pw, 3) filled with the pad value.  Filled
    channel by channel from python floats: a host->device copy of the pad
    vector would make the host wait for the device on every step."""
    b, h, w, c = x.shape
    out = x.new_empty((b, ph, pw, c))
    for i, v in enumerate(_pad_value().tolist()):
        out[..., i] = v
    out[:, :h, :w] = x
    return out


def _crop_batch(images: torch.Tensor, base_size: int, crop_size: int):
    """(B * n_crops, crop, crop, 3) crop-major batch plus the window plan."""
    _, h, w, _ = images.shape
    height, width, ph, pw, crops = plan_windows(h, w, base_size, crop_size)
    x = images if (h, w) == (height, width) \
        else resize_bilinear_align_corners(images, height, width)
    canvas_in = _pad_canvas(x, ph, pw)
    pieces = []
    for (h0, h1, w0, w1) in crops:
        piece = canvas_in[:, h0:h1, w0:w1]
        if (h1 - h0, w1 - w0) != (crop_size, crop_size):
            piece = _pad_canvas(piece, crop_size, crop_size)
        pieces.append(piece)
    return torch.cat(pieces, dim=0), (height, width, ph, pw, crops)


def sliding_window_features(apply_fn: Callable, images: torch.Tensor,
                            base_size: int = 520, crop_size: int = 480,
                            flip: bool = False) -> torch.Tensor:
    """Full-canvas pixel features (B, height, width, D) f32 for a batch of
    normalised (B, H, W, 3) frames.

    ``flip=True`` adds the horizontally mirrored evaluation of every padded
    crop, mirrored back (the reference's module_inference,
    additional_utils/models.py:134-140: a SUM, not an average); the
    mirrored crops join the same batched forward."""
    b = images.shape[0]
    batch, (height, width, ph, pw, crops) = _crop_batch(images, base_size,
                                                        crop_size)
    if flip:
        batch = torch.cat([batch, batch.flip(2)])
    feats = apply_fn(batch)
    if flip:
        n = batch.shape[0] // 2
        feats = feats[:n] + feats[n:].flip(2)
    if feats.shape[1] != crop_size or feats.shape[2] != crop_size:
        raise ValueError(
            f"model output {tuple(feats.shape[1:3])} != crop {crop_size}: the "
            "overlap merge needs a resolution-preserving model (patch-16 "
            "LSeg); use LSegConfig.tiny16 for small tests")
    d = feats.shape[-1]
    out = torch.zeros((b, ph, pw, d), dtype=torch.float32,
                      device=images.device)
    count = torch.zeros((1, ph, pw, 1), dtype=torch.float32,
                        device=images.device)
    for ci, (h0, h1, w0, w1) in enumerate(crops):
        piece = feats[ci * b:(ci + 1) * b, :h1 - h0, :w1 - w0]
        out[:, h0:h1, w0:w1] += piece.float()
        count[:, h0:h1, w0:w1] += 1.0
    out = out / count
    return out[:, :height, :width]


def bilinear_patch_sample(fmap: torch.Tensor, sx: torch.Tensor,
                          sy: torch.Tensor) -> torch.Tensor:
    """Edge-safe bilinear sample of (B, H, W, D) maps at f32 coords (B, N),
    already clipped to [0, W-1] x [0, H-1]: start = min(floor(s), size-2),
    t = s - start in [0, 1].  Returns (B, N, D) f32."""
    b, h, w, d = fmap.shape
    ys = torch.clamp(torch.floor(sy), 0, h - 2).to(torch.int64)
    xs = torch.clamp(torch.floor(sx), 0, w - 2).to(torch.int64)
    ty = (sy - ys.to(torch.float32))[..., None]
    tx = (sx - xs.to(torch.float32))[..., None]
    flat = fmap.reshape(b, h * w, d)

    def corner(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, d)
        return torch.gather(flat, 1, idx)

    return ((1 - ty) * (1 - tx) * corner(ys, xs)
            + (1 - ty) * tx * corner(ys, xs + 1)
            + ty * (1 - tx) * corner(ys + 1, xs)
            + ty * tx * corner(ys + 1, xs + 1))


def whole_canvas_features_at_points(apply_fn: Callable, images: torch.Tensor,
                                    px: torch.Tensor,
                                    py: torch.Tensor) -> torch.Tensor:
    """One forward over the whole canvas padded to a multiple of 32 instead
    of the overlapping crop grid (~2.4x fewer encoder FLOPs at 1080x720; not
    numerically the sliding window).  Features are gathered at (px, py)
    directly from a full-res output, or through the half-res align-corners
    map.  Returns (B, N, D)."""
    b, h, w, _ = images.shape
    ph = -(-h // 32) * 32
    pw = -(-w // 32) * 32
    feats = apply_fn(_pad_canvas(images, ph, pw))
    fh, fw = feats.shape[1], feats.shape[2]
    if (fh, fw) == (ph, pw):
        gx = torch.clamp(px, 0, pw - 1).long()
        gy = torch.clamp(py, 0, ph - 1).long()
        return feats[torch.arange(b, device=feats.device)[:, None], gy, gx]
    if (fh * 2, fw * 2) != (ph, pw):
        raise ValueError(f"model output {(fh, fw)} is neither full nor half "
                         f"of the padded canvas {(ph, pw)}")
    sx = torch.clamp(px.float(), 0, pw - 1) * ((fw - 1) / (pw - 1))
    sy = torch.clamp(py.float(), 0, ph - 1) * ((fh - 1) / (ph - 1))
    return bilinear_patch_sample(feats, sx, sy)


def features_at_points(apply_fn: Callable, images: torch.Tensor,
                       px: torch.Tensor, py: torch.Tensor,
                       base_size: int = 520, crop_size: int = 480,
                       half_res_apply: bool = False) -> torch.Tensor:
    """Pixel features (B, N, D) at per-frame feature-canvas coords
    ``px``/``py`` (B, N).  Out-of-canvas coords give garbage rows that the
    caller masks.  ``half_res_apply=True`` expects ``apply_fn`` to return
    half-crop-resolution maps and samples each covering crop's map
    bilinearly, averaging over the crops -- the same numbers as
    materialising the full canvas, without it."""
    if not half_res_apply:
        canvas = sliding_window_features(apply_fn, images, base_size,
                                         crop_size)
        b, hh, ww, _ = canvas.shape
        gx = torch.clamp(px, 0, ww - 1).long()
        gy = torch.clamp(py, 0, hh - 1).long()
        return canvas[torch.arange(b, device=canvas.device)[:, None], gy, gx]
    return _features_at_points_halfres(apply_fn, images, px, py, base_size,
                                       crop_size)


def _features_at_points_halfres(apply_fn: Callable, images: torch.Tensor,
                                px: torch.Tensor, py: torch.Tensor,
                                base_size: int, crop_size: int
                                ) -> torch.Tensor:
    b = images.shape[0]
    batch, (_, _, _, _, crops) = _crop_batch(images, base_size, crop_size)
    feats = apply_fn(batch)
    hh = feats.shape[1]
    if hh * 2 != crop_size:
        raise ValueError(
            f"half-res apply returned {hh}, expected {crop_size // 2}")
    d = feats.shape[-1]
    n = px.shape[1]
    nc = len(crops)

    pxf, pyf = px.float(), py.float()
    # half-res align-corners coordinate map: full i -> i * (hh-1)/(2hh-1)
    scale = (hh - 1) / (crop_size - 1)

    # per-crop local coords stacked on a leading crop axis (nc, B, N); the
    # crop bounds are python ints, so nothing is copied to the device
    lx = torch.stack([pxf - c[2] for c in crops])
    ly = torch.stack([pyf - c[0] for c in crops])
    inside = torch.stack([(pxf >= c[2]) & (pxf < c[3]) & (pyf >= c[0])
                          & (pyf < c[1]) for c in crops])
    sx = torch.clamp(lx, 0, crop_size - 1) * scale
    sy = torch.clamp(ly, 0, crop_size - 1) * scale
    val = bilinear_patch_sample(feats, sx.reshape(nc * b, n),
                                sy.reshape(nc * b, n))
    m = inside.reshape(nc, b, n, 1).to(torch.float32)
    acc = torch.sum(val.reshape(nc, b, n, d) * m, dim=0)
    cnt = torch.sum(m, dim=0)
    return acc / torch.clamp(cnt, min=1.0)
