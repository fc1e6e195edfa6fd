"""CLIP's image preprocess on the card: PIL's bicubic resize, the centre
crop and the normalise in one kernel, byte for byte as PIL computes them.

``models/clip/model.py::preprocess_images`` resizes a frame's short side
to ``size`` with PIL's bicubic filter, keeps the centre ``size`` x
``size`` and normalises ``(v / 255 - mean) / std`` in f32.  PIL's 8-bit
resampling (``libImaging/Resample.c``) is integer arithmetic over
coefficient tables: ``precompute_coeffs`` builds them in double (the
a = -0.5 cubic, support 2 x the downscale), ``normalize_coeffs_8bpc``
rounds them to fixed point with 22 fraction bits, the horizontal pass
runs first and rounds to uint8 (``clip8``), and the vertical pass runs on
that uint8 result.  :func:`crop_tables` rebuilds the tables on the host
in Python doubles, which round as PIL's C does (device code would contract
the double arithmetic into FMAs), for the cropped outputs only: an output
pixel depends on its own taps alone, so leaving out the columns and rows
the crop drops leaves every byte as it was.

``clip_resample`` takes a (B, H, W, 3) uint8 batch.  A tensor on the CPU
takes the plain version (integer torch over the same tables); a CUDA
tensor launches the kernel of ``csrc/clip_resample.cu`` or raises.
``clip_resample.launches`` counts kernel launches (one a call).
:class:`FramePreprocess` takes a batch of host frames of any shapes
through one pinned staging buffer to the device and calls it once a
shape.
"""

from __future__ import annotations

import functools
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from avlmaps_torch.kernels import build
from avlmaps_torch.kernels.build import require

PRECISION_BITS = 22  # Resample.c: 32 - 8 bits of the pixel - 2 of headroom
_HALF = 1 << (PRECISION_BITS - 1)

_BAND = 16                  # output rows a block
# numpy's copy releases the GIL: 64 720x1080 frames from a fresh memmap
# into pinned memory took 42 ms on one thread, 13.6 on 4 and 11.7 on 8
# (an H100 machine's host, PERF.md)
_COPY_THREADS = 8
_SMEM_BUDGET = 72 * 1024    # three blocks an SM at the CLIP shapes
_SMEM_MAX = 232448          # what one block may opt in to on Hopper


def _bicubic(x: float) -> float:
    """Resample.c's ``bicubic_filter``, a = -0.5, in the same order of
    operations."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def pil_coeffs(in_size: int, out_size: int, first: int = 0,
               count: int = None):
    """Pillow's bicubic tables for resizing ``in_size`` to ``out_size``,
    outputs ``first`` .. ``first + count - 1``: ``bounds`` (count, 2)
    int32, each output's first input and number of taps, and ``coeffs``
    (count, ksize) int32, its fixed-point weights (zero past its taps).
    ``precompute_coeffs`` then ``normalize_coeffs_8bpc``, in doubles."""
    count = out_size - first if count is None else count
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    one = float(1 << PRECISION_BITS)
    bounds = np.zeros((count, 2), np.int32)
    coeffs = np.zeros((count, ksize), np.int32)
    for j in range(count):
        center = (first + j + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        coeffs[j, :xmax] = [int(-0.5 + v * one) if v < 0 else
                            int(0.5 + v * one) for v in w]
        bounds[j] = xmin, xmax
    return bounds, coeffs


class CropTables(NamedTuple):
    """The tables of one input shape: the horizontal pass's (cropped
    columns) and the vertical pass's (cropped rows)."""
    hb: np.ndarray
    hk: np.ndarray
    vb: np.ndarray
    vk: np.ndarray


@functools.lru_cache(maxsize=64)
def crop_tables(h: int, w: int, size: int) -> CropTables:
    """Tables for an (h, w) frame: resized as ``preprocess_images`` does
    (short side to ``size``, the other ``max(size, round(side * scale))``),
    then centre-cropped to ``size`` x ``size``."""
    scale = size / min(w, h)
    rw = max(size, int(round(w * scale)))
    rh = max(size, int(round(h * scale)))
    hb, hk = pil_coeffs(w, rw, (rw - size) // 2, size)
    vb, vk = pil_coeffs(h, rh, (rh - size) // 2, size)
    return CropTables(hb, hk, vb, vk)


def _pass(x: torch.Tensor, bounds: np.ndarray, coeffs: np.ndarray,
          axis: int) -> torch.Tensor:
    """One of PIL's 8-bit passes along ``axis`` of an int32 tensor: each
    output is ``clip8(2^21 + sum of taps x weights)``."""
    dev = x.device
    n = x.shape[axis]
    idx = torch.from_numpy(bounds[:, :1]
                           + np.arange(coeffs.shape[1])).to(dev)
    taps = x.index_select(axis, idx.clamp(max=n - 1).reshape(-1))
    taps = taps.unflatten(axis, idx.shape)
    k = torch.from_numpy(coeffs).to(dev)
    k = k.reshape(k.shape + (1,) * (x.dim() - axis - 1))
    acc = (taps * k).sum(axis + 1, dtype=torch.int32) + _HALF
    return (acc >> PRECISION_BITS).clamp(0, 255)


def clip_resample_ref(frames: torch.Tensor, size: int, mean: Sequence[float],
                      std: Sequence[float]) -> torch.Tensor:
    """Plain version: (B, H, W, 3) uint8 -> (B, size, size, 3) f32, PIL's
    two integer passes over :func:`crop_tables`, then ``(v / 255 - mean) /
    std`` in f32 (every operand a tensor, so the division is IEEE on either
    device)."""
    b, h, w, _ = frames.shape
    t = crop_tables(h, w, size)
    dev = frames.device
    out = []
    for img in frames:  # one frame at a time bounds the taps' memory
        y0 = int(t.vb[0, 0])
        y1 = int(t.vb[-1, 0] + t.vb[-1, 1])
        rows = img[y0:y1].to(torch.int32)
        horiz = _pass(rows, t.hb, t.hk, 1)
        vb = t.vb - np.array([y0, 0], np.int32)
        out.append(_pass(horiz, vb, t.vk, 0))
    v = (torch.stack(out) if out else
         torch.zeros((0, size, size, 3), dtype=torch.int32, device=dev))
    f32 = dict(dtype=torch.float32, device=dev)
    return ((v.float() / torch.full((3,), 255.0, **f32))
            - torch.as_tensor(np.asarray(mean, np.float32), **f32)) \
        / torch.as_tensor(np.asarray(std, np.float32), **f32)


def _launch_shape(t: CropTables, size: int):
    """(band, rows, pitch, shared bytes): ``pitch`` is a staged input row's
    bytes (the columns the crop reads, plus up to 15 of 16-byte
    alignment); ``rows`` input rows are staged at once, as many as fit the
    budget beside the band's int32 sums and the rows' horizontal pass."""
    e = size * 3
    band = min(_BAND, size)
    seg = int(t.hb[-1, 0] + t.hb[-1, 1] - t.hb[0, 0]) * 3
    pitch = (seg + 15 + 15) // 16 * 16
    sums = (band * e * 4 + 15) // 16 * 16
    ends = t.vb[:, 0] + t.vb[:, 1]
    starts = t.vb[::band, 0]
    span = int(max(ends[min(i + band, size) - 1] - s
                   for i, s in zip(range(0, size, band), starts)))
    rows = max(1, min(span, (_SMEM_BUDGET - sums) // (pitch + e)))
    return band, rows, pitch, sums + rows * (pitch + e)


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, size: int, device: torch.device):
    """The tables on ``device`` as one int32 buffer (horizontal bounds,
    vertical bounds, horizontal weights tap-major, vertical weights) with
    the launch shape, built once per frame shape."""
    t = crop_tables(h, w, size)
    flat = np.concatenate([t.hb.ravel(), t.vb.ravel(), t.hk.T.ravel(),
                           t.vk.ravel()])
    return (torch.from_numpy(flat).to(device), t.hk.shape[1],
            t.vk.shape[1], _launch_shape(t, size))


def clip_resample(frames: torch.Tensor, size: int, mean: Sequence[float],
                  std: Sequence[float]) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) f32: PIL's bicubic resize
    of the short side to ``size``, the centre crop and the normalise."""
    require(frames.dim() == 4 and frames.shape[-1] == 3
            and frames.dtype == torch.uint8,
            "clip_resample: need (B, H, W, 3) uint8, got {} {}",
            tuple(frames.shape), frames.dtype)
    require(frames.shape[1] > 0 and frames.shape[2] > 0,
            "clip_resample: empty frame")
    if frames.device.type == "cpu":
        return clip_resample_ref(frames, size, mean, std)
    require(frames.is_cuda, "clip_resample: unsupported device {}",
            frames.device)
    require(frames.is_contiguous(), "clip_resample: frames must be "
            "contiguous")
    b, h, w, _ = frames.shape
    require(b < 65536, "clip_resample: at most 65535 frames a call, got {}",
            b)
    tab, kh, kv, (band, rows, pitch, smem) = _device_tables(
        h, w, size, frames.device)
    require(smem <= _SMEM_MAX, "clip_resample: a {}-pixel-wide frame needs "
            "{} bytes of shared memory", w, smem)
    out = torch.empty((b, size, size, 3), dtype=torch.float32,
                      device=frames.device)
    if b == 0:
        return out
    m = [float(v) for v in np.asarray(mean, np.float32)]
    s = [float(v) for v in np.asarray(std, np.float32)]
    build.check(build.load("clip_resample").avl_clip_resample(
        frames.data_ptr(), out.data_ptr(), tab.data_ptr(), b, h, w, size, kh,
        kv, band, rows, pitch, *m, *s,
        torch.cuda.current_stream(frames.device).cuda_stream),
        "clip_resample")
    clip_resample.launches += 1
    return out


clip_resample.launches = 0


def _as_frame(img) -> np.ndarray:
    """``preprocess_images``' reading of one frame: an empty frame is one
    black pixel, any other dtype is cast to uint8 (``np.uint8(img)``)."""
    a = np.asarray(img)
    if a.shape[0] == 0 or a.shape[1] == 0:
        return np.zeros((1, 1, 3), np.uint8)
    require(a.ndim == 3 and a.shape[2] == 3,
            "clip_resample: need HWC RGB frames, got {}", a.shape)
    return a if a.dtype == np.uint8 else a.astype(np.uint8)


class FramePreprocess:
    """``preprocess_images`` on ``device``: a batch of HWC frames is
    copied straight into one staging buffer (pinned for a CUDA device,
    reused across batches and grown only for a larger one) by up to
    ``_COPY_THREADS`` threads, uploaded without making the host wait, and
    resized there by :func:`clip_resample`, one call per frame shape in
    order of first appearance.  Returns (B, size, size, 3) f32 on
    ``device``."""

    def __init__(self, size: int, mean: Sequence[float], std: Sequence[float],
                 device: torch.device):
        self.size, self.mean, self.std = size, mean, std
        self.device = torch.device(device)
        self._buf = None
        self._uploaded = None  # event: the last upload has left the buffer
        self._lock = threading.Lock()

    def _staging(self, nbytes: int) -> torch.Tensor:
        if self._uploaded is not None:
            self._uploaded.synchronize()
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None
            self._buf = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
        return self._buf

    def __call__(self, imgs: Sequence[np.ndarray]) -> torch.Tensor:
        frames = [_as_frame(img) for img in imgs]
        if not frames:
            return torch.empty((0, self.size, self.size, 3),
                               device=self.device)
        groups = {}
        for i, a in enumerate(frames):
            groups.setdefault(a.shape, []).append(i)
        spans, end = [], 0
        for shape, idx in groups.items():
            off = (end + 15) // 16 * 16  # each shape's frames 16-byte aligned
            end = off + len(idx) * math.prod(shape)
            spans.append((shape, idx, off, end))
        # one batch in the staging buffer at a time; on the CPU the
        # resample reads it in place
        with self._lock:
            buf = self._staging(end)
            host = buf.numpy()
            jobs = []
            for shape, idx, off, stop in spans:
                block = host[off:stop].reshape(len(idx), *shape)
                jobs += [(block[j], frames[i]) for j, i in enumerate(idx)]
            with ThreadPoolExecutor(min(_COPY_THREADS, len(jobs))) as pool:
                list(pool.map(lambda job: np.copyto(*job), jobs))
            dev = buf[:end].to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                self._uploaded = torch.cuda.Event()
                self._uploaded.record()
            out = None
            with record_function("clip.resample"):
                for shape, idx, off, stop in spans:
                    y = clip_resample(dev[off:stop].view(len(idx), *shape),
                                      self.size, self.mean, self.std)
                    if len(spans) == 1:
                        return y
                    if out is None:
                        out = y.new_empty((len(frames),) + y.shape[1:])
                    out.index_copy_(0, torch.tensor(idx, device=self.device),
                                    y)
            return out
