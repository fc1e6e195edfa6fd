"""The VLMap of a build with whole-canvas LSeg and the pixels drawn on the
card, computed plainly: ``reference/vlmap.py``'s semantics with three
changes.

- **Draws.**  Entry ``i`` of the sequence draws ``h * w // rate`` flat
  pixel indices as JAX's ``random.randint(fold_in(PRNGKey(seed), i),
  (n,), 0, h * w)`` (threefry2x32 with partitionable bits, the default
  since JAX 0.5), written here in numpy from the algorithm (Salmon et al.
  2011, "Parallel random numbers: as easy as 1, 2, 3"; JAX's
  ``_src/prng.py`` and ``_src/random.py``), sorted; a repeated draw
  counts once.
- **LSeg.**  One forward a frame over the canvas padded (with the
  normalised zero, -1) to multiples of 32; a point's feature is the
  half-resolution output's align-corners bilinear sample at its canvas
  pixel.
- **Colour.**  The canvas's pixel nearest the drawn pixel scaled by
  ``(cw - 1) / (w - 1)`` and ``(ch - 1) / (h - 1)`` in f32, half to even.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.data.scene import cam_to_map
from portbench.reference import lseg
from portbench.reference.precision import Precision
from portbench.reference.vlmap import geometry, plan_windows, resize_u8

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Tuple[np.ndarray, np.ndarray], x0, x1):
    """Threefry-2x32, 20 rounds, of the count pairs (x0, x1) under
    ``key``: uint32 arrays that broadcast; additions wrap."""
    u32 = np.uint32
    k0, k1 = (np.asarray(k, u32) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0 = np.asarray(x0, u32) + ks[0]
    x1 = np.asarray(x1, u32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def fold_in(seed: int, data: np.ndarray):
    """``fold_in(PRNGKey(seed), data)`` for a seed in [0, 2**31): the key
    (0, seed) hashes the count pair (0, uint32(data))."""
    d = np.asarray(data).astype(np.uint32)
    return threefry2x32((np.uint32(0), np.uint32(seed)), np.zeros_like(d), d)


def randint(key, n: int, span: int) -> np.ndarray:
    """``randint(key, (n,), 0, span)`` for each key of a batch (B,) ->
    (B, n) int64: two keys split off (the hashes of (0, 0) and (0, 1)),
    32 bits a value from each (the two words of the hash of (0, i),
    xored), ``(hi % span) * (2**32 % span) + lo % span`` in uint32, mod
    ``span``."""
    u32 = np.uint32
    k0, k1 = (np.asarray(k, u32)[..., None] for k in key)
    counts = np.arange(n, dtype=u32)

    def bits(sub):
        b0, b1 = threefry2x32(threefry2x32((k0, k1), u32(0), u32(sub)),
                              u32(0), counts)
        return b0 ^ b1

    hi, lo = bits(0), bits(1)
    mult = u32((2 ** 16 % span) ** 2 % 2 ** 32 % span)
    off = (hi % u32(span)) * mult + lo % u32(span)
    return (off % u32(span)).astype(np.int64)


def draws(seed: int, n: int, h: int, w: int, rate: int) -> np.ndarray:
    """(n, h * w // rate) sorted flat pixel indices, entry i's from
    ``fold_in(PRNGKey(seed), i)``."""
    out = randint(fold_in(seed, np.arange(n)), max(h * w // rate, 1), h * w)
    return np.sort(out, axis=1)


def build(frames: Tuple[np.ndarray, np.ndarray], src: np.ndarray,
          pose_vecs: np.ndarray, map_cfg: Dict, spec: Dict,
          sd: Dict[str, torch.Tensor], seed: int, precision: str = "f32",
          device="cuda", chunk: int = 8) -> Dict[str, np.ndarray]:
    """The reference map of a build over a sequence whose entry ``i``
    shows frame ``src[i]`` of ``frames`` from pose ``pose_vecs[i]``, as
    ``reference.vlmap.build`` returns it."""
    rgb, depth = frames
    src = np.asarray(src)
    n = len(src)
    _, h, w, _ = rgb.shape
    p = Precision(precision)
    dev = torch.device(device)
    ch, cw = plan_windows(h, w, map_cfg["lseg_base_size"],
                          map_cfg["lseg_crop_size"])[:2]
    ph, pw = -(-ch // 32) * 32, -(-cw // 32) * 32
    idx = draws(seed, n, h, w, map_cfg["depth_sample_rate"])
    vid, fx, fy, alpha, valid = geometry(
        depth, src, idx, cam_to_map(pose_vecs, map_cfg["pose_info"]),
        map_cfg, (ch, cw), dev)
    repeat = np.zeros(idx.shape, bool)
    repeat[:, 1:] = idx[:, 1:] == idx[:, :-1]
    valid &= ~torch.from_numpy(repeat).to(dev)
    f32 = np.float32
    cx = np.clip(np.rint((idx % w).astype(f32) * f32((cw - 1) / (w - 1))),
                 0, cw - 1).astype(np.int64)
    cy = np.clip(np.rint((idx // w).astype(f32) * f32((ch - 1) / (h - 1))),
                 0, ch - 1).astype(np.int64)
    at = torch.from_numpy(cy * cw + cx).to(dev)
    uniq, inv = torch.unique(vid[valid], return_inverse=True)
    slot = torch.full(vid.shape, -1, dtype=torch.long, device=dev)
    slot[valid] = inv
    d = spec["out_dim"]
    s_w = torch.zeros(uniq.shape[0], dtype=torch.float64, device=dev)
    s_f = torch.zeros((uniq.shape[0], d), dtype=torch.float64, device=dev)
    s_c = torch.zeros((uniq.shape[0], 3), dtype=torch.float64, device=dev)
    shown = sorted(set(src.tolist()))
    for s in range(0, len(shown), chunk):
        part = shown[s:s + chunk]
        canvas_u8 = resize_u8(torch.from_numpy(rgb[part]).to(dev), ch, cw)
        padded = torch.full((len(part), ph, pw, 3), -1.0, device=dev)
        padded[:, :ch, :cw] = canvas_u8.float() / 127.5 - 1.0
        emb = lseg.half_res_embeddings(sd, padded, spec, p)
        for b, frame in enumerate(part):
            colours = canvas_u8[b].reshape(-1, 3)
            for i in np.flatnonzero(src == frame):
                ok = valid[i]
                f = lseg.upsampled_at(emb[b], fx[i][ok], fy[i][ok]).double()
                a = alpha[i][ok]
                col = colours[at[i][ok]].double()
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
