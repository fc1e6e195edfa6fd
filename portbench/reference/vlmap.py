"""The VLMap a build should produce, computed plainly.

Semantics (AVLMaps ``vlmap_builder.py:54-185``, ``lseg_utils.py:20-119``,
``mapping_utils.py``): per frame, the depth pixels drawn by the
builder's sampler (one in ``depth_sample_rate``, the benchmark's copy of
its draw below) are back-projected through the camera at their pixel
centres, moved to the map frame and binned into cells of ``cs`` (the
reference's scalar converter: ``int(gs/2 - int(x/cs))``); each keeps its
point if the depth lies in (min, max), the cell in the grid and the
point on the LSeg canvas.  The canvas is the frame resized with
align-corners bilinear to ``base_size`` on the long side; LSeg runs on
the sliding ``crop_size`` windows of the padded canvas and the overlap
is averaged.  A voxel's feature is the ConceptFusion-weighted mean
(``exp(-|p|^2 / 1.2)``) of its points' features, its colour the weighted
mean colour truncated to uint8, its weight the sum of the weights.

Geometry and the fusion sums are in f64; LSeg in the precision asked.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.data.scene import calib_matrix, cam_to_map
from portbench.reference import lseg
from portbench.reference.precision import Precision


def plan_windows(h: int, w: int, base_size: int, crop_size: int):
    """(canvas h, canvas w, padded h, padded w, crops (h0, h1, w0, w1))."""
    stride = int(crop_size * 2.0 / 3.0)
    if h > w:
        ch, cw = base_size, int(1.0 * w * base_size / h + 0.5)
    else:
        cw, ch = base_size, int(1.0 * h * base_size / w + 0.5)
    ph, pw = max(ch, crop_size), max(cw, crop_size)
    crops = []
    for i in range(int(math.ceil((ph - crop_size) / stride)) + 1):
        for j in range(int(math.ceil((pw - crop_size) / stride)) + 1):
            h0, w0 = i * stride, j * stride
            crops.append((h0, min(h0 + crop_size, ph), w0,
                          min(w0 + crop_size, pw)))
    return ch, cw, ph, pw, crops


def sample_pixels(rng: np.random.Generator, h: int, w: int, rate: int,
                  max_pts: int, batch: int) -> np.ndarray:
    """The builder's host draw, kept as the benchmark's copy: per frame
    ~h*w/rate unique pixels (oversample with replacement, unique,
    subsample the surplus), tiled to ``max_pts``."""
    n_target = min(max(h * w // rate, 1), max_pts)
    idx = np.empty((batch, max_pts), np.int32)
    for b in range(batch):
        over = rng.integers(0, h * w, int(n_target * 1.3) + 16)
        pick = np.unique(over)
        if pick.shape[0] < n_target:
            extra = rng.choice(h * w, size=n_target - pick.shape[0],
                               replace=False)
            pick = np.concatenate([pick, extra])
        elif pick.shape[0] > n_target:
            pick = pick[rng.choice(pick.shape[0], n_target, replace=False)]
        reps = int(np.ceil(max_pts / n_target))
        idx[b] = np.tile(pick, reps)[:max_pts]
    return idx


def resize_u8(rgb: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> align-corners bilinear, rounded, uint8."""
    _, h, w, _ = rgb.shape

    def plan(n_in, n_out):
        c = torch.arange(n_out, dtype=torch.float64, device=rgb.device) \
            * ((n_in - 1) / (n_out - 1))
        lo = c.floor().clamp(0, n_in - 1).long()
        hi = (lo + 1).clamp(max=n_in - 1)
        return lo, hi, (c - lo).float()

    ylo, yhi, fy = plan(h, oh)
    xlo, xhi, fx = plan(w, ow)
    x = rgb.float()
    x = x[:, ylo] * (1 - fy)[None, :, None, None] \
        + x[:, yhi] * fy[None, :, None, None]
    x = x[:, :, xlo] * (1 - fx)[None, None, :, None] \
        + x[:, :, xhi] * fx[None, None, :, None]
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def sample_all(n: int, h: int, w: int, map_cfg: Dict, seed: int,
               batch: int) -> np.ndarray:
    """(n, max_pts) pixel draws: one generator seeded with ``seed``,
    drawn batch by batch of ``batch`` frames (the last one padded)."""
    rng = np.random.default_rng(seed)
    max_pts = max(h * w // map_cfg["depth_sample_rate"], 1)
    out = []
    for s in range(0, n, batch):
        out.append(sample_pixels(rng, h, w, map_cfg["depth_sample_rate"],
                                 max_pts, batch)[:min(batch, n - s)])
    return np.concatenate(out)


def geometry(depth: np.ndarray, src: np.ndarray, idx: np.ndarray,
             tfs: np.ndarray, map_cfg: Dict, canvas_hw: Tuple[int, int],
             device):
    """Per entry of the sequence and drawn pixel: voxel id, canvas
    coords (fx, fy), weight and validity, in f64.  Entry ``i`` shows
    frame ``src[i]`` of ``depth``, read as the dataset's uint16
    millimetres."""
    k, h, w = depth.shape
    gs, cs = map_cfg["grid_size"], map_cfg["cell_size"]
    vh = int(map_cfg["pose_info"]["camera_height"] / cs)
    dev = torch.device(device)
    f64 = torch.float64
    mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16).reshape(k, -1)
    z = torch.from_numpy(mm[np.asarray(src)[:, None], idx]
                         .astype(np.float64) * 1e-3).to(dev)
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
    px = (idx_t % w).to(f64)
    py = (idx_t // w).to(f64)
    inv_k = torch.tensor(np.linalg.inv(calib_matrix(map_cfg)), dtype=f64,
                         device=dev)
    uv1 = torch.stack([px + 0.5, py + 0.5, torch.ones_like(px)], -1)
    local = (uv1 @ inv_k.T) * z[..., None]
    tf = torch.tensor(tfs, dtype=f64, device=dev)
    world = local @ tf[:, :3, :3].transpose(1, 2) + tf[:, None, :3, 3]
    row = torch.trunc(gs / 2 - torch.trunc(world[..., 0] / cs))
    col = torch.trunc(gs / 2 - torch.trunc(world[..., 1] / cs))
    hgt = torch.trunc(world[..., 2] / cs)
    in_grid = ((row >= 0) & (row < gs) & (col >= 0) & (col < gs)
               & (hgt >= 0) & (hgt < vh))
    ch, cw = canvas_hw
    fk = torch.tensor([[cw / 2, 0, cw / 2], [0, cw / 2, ch / 2], [0, 0, 1]],
                      dtype=f64, device=dev)
    uvw = local @ fk.T
    fx = torch.trunc(uvw[..., 0] / uvw[..., 2] - 0.5)
    fy = torch.trunc(uvw[..., 1] / uvw[..., 2] - 0.5)
    in_feat = (fx >= 0) & (fx < cw) & (fy >= 0) & (fy < ch)
    valid = ((z > map_cfg["min_depth"]) & (z < map_cfg["max_depth"])
             & in_grid & in_feat)
    vid = (row * gs * vh + col * vh + hgt).long()
    alpha = torch.exp(-(local * local).sum(-1) / 1.2)
    return vid, fx.long(), fy.long(), alpha, valid


def point_features(emb: torch.Tensor, crops: List[Tuple[int, int, int, int]],
                   fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """The crop-averaged full-resolution embedding at canvas pixels
    (fx, fy) of one frame; ``emb`` is (n_crops, h/2, w/2, D)."""
    acc = torch.zeros((fx.shape[0], emb.shape[-1]), dtype=torch.float64,
                      device=emb.device)
    cnt = torch.zeros((fx.shape[0], 1), dtype=torch.float64,
                      device=emb.device)
    for ci, (h0, h1, w0, w1) in enumerate(crops):
        inside = (fx >= w0) & (fx < w1) & (fy >= h0) & (fy < h1)
        sel = inside.nonzero()[:, 0]
        acc[sel] += lseg.upsampled_at(emb[ci], fx[sel] - w0,
                                      fy[sel] - h0).double()
        cnt[sel] += 1
    return acc / cnt.clamp(min=1)


def build(frames: Tuple[np.ndarray, np.ndarray], src: np.ndarray,
          pose_vecs: np.ndarray, map_cfg: Dict, spec: Dict,
          sd: Dict[str, torch.Tensor], seed: int, batch: int,
          precision: str = "f32", device="cuda",
          chunk: int = 8) -> Dict[str, np.ndarray]:
    """The reference map of a build over a sequence whose entry ``i``
    shows frame ``src[i]`` of ``frames`` (RGB uint8, depth metres) from
    pose ``pose_vecs[i]``: ``vid`` (sorted voxel ids row * gs * vh +
    col * vh + h), ``weight``, ``feat`` (weighted means, f32), ``rgb``
    (uint8).  LSeg runs once on each frame; each entry fuses its own
    pixel draws."""
    rgb, depth = frames
    src = np.asarray(src)
    n = len(src)
    _, h, w, _ = rgb.shape
    p = Precision(precision)
    dev = torch.device(device)
    ch, cw, ph, pw, crops = plan_windows(h, w, map_cfg["lseg_base_size"],
                                         map_cfg["lseg_crop_size"])
    crop = map_cfg["lseg_crop_size"]
    idx = sample_all(n, h, w, map_cfg, seed, batch)
    vid, fx, fy, alpha, valid = geometry(
        depth, src, idx, cam_to_map(pose_vecs, map_cfg["pose_info"]),
        map_cfg, (ch, cw), dev)
    uniq, inv = torch.unique(vid[valid], return_inverse=True)
    slot = torch.full(vid.shape, -1, dtype=torch.long, device=dev)
    slot[valid] = inv
    d = spec["out_dim"]
    s_w = torch.zeros(uniq.shape[0], dtype=torch.float64, device=dev)
    s_f = torch.zeros((uniq.shape[0], d), dtype=torch.float64, device=dev)
    s_c = torch.zeros((uniq.shape[0], 3), dtype=torch.float64, device=dev)
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
    shown = sorted(set(src.tolist()))
    for s in range(0, len(shown), chunk):
        part = shown[s:s + chunk]
        frames_u8 = torch.from_numpy(rgb[part]).to(dev)
        canvas = resize_u8(frames_u8, ch, cw).float() / 127.5 - 1.0
        padded = torch.full((len(part), ph, pw, 3), -1.0, device=dev)
        padded[:, :ch, :cw] = canvas
        pieces = []
        for (h0, h1, w0, w1) in crops:
            piece = torch.full((len(part), crop, crop, 3), -1.0, device=dev)
            piece[:, :h1 - h0, :w1 - w0] = padded[:, h0:h1, w0:w1]
            pieces.append(piece)
        emb = lseg.half_res_embeddings(sd, torch.cat(pieces), spec, p)
        emb = emb.view(len(crops), len(part), *emb.shape[1:])
        for b, frame in enumerate(part):
            for i in np.flatnonzero(src == frame):
                ok = valid[i]
                f = point_features(emb[:, b], crops, fx[i][ok], fy[i][ok])
                a = alpha[i][ok]
                col = frames_u8[b].reshape(-1, 3)[idx_t[i][ok]].double()
                sl = slot[i][ok]
                s_w.index_add_(0, sl, a)
                s_f.index_add_(0, sl, a[:, None] * f)
                s_c.index_add_(0, sl, a[:, None] * col)
        del emb
    den = s_w.clamp(min=1e-300)[:, None]
    return {"vid": uniq.cpu().numpy(),
            "weight": s_w.float().cpu().numpy(),
            "feat": (s_f / den).float().cpu().numpy(),
            "rgb": (s_c / den).clamp(0, 255).to(torch.uint8).cpu().numpy()}
