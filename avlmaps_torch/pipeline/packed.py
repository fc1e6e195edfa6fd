"""Packed-scene ingestion: decode a scene once, stream it from a file.

Counterpart of ``avlmaps_tpu/pipeline/packed.py``; the file format is the
same, so a pack written by either package is read by both, and
:func:`pack_scene` writes the same bytes as the JAX package's writer.
Format (``.avpack``): ``MAGIC``, a u64 JSON header length, the JSON
header, then 64-byte aligned little-endian sections that ``np.memmap``
views directly: ``rgb`` (N, H, W, 3) uint8, ``depth`` (N, H, W) uint16 mm
or float32 metres, and optionally ``canvas`` (N, ch, cw, 3) uint8, the
resized LSeg canvas.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.pipeline.loader import (FrameBatch, _QueueLoader,
                                           load_depth, load_rgb)
from avlmaps_torch.pipeline.transport import (CanvasBatch, RawCanvasBatch,
                                              resize_canvas_u8)

MAGIC = b"AVLPACK1"
_ALIGN = 64


def _paths_digest(paths: Sequence) -> str:
    """Order-sensitive digest of the source file names (not contents)."""
    h = hashlib.sha1()
    for p in paths:
        h.update(os.path.basename(str(p)).encode())
        h.update(b"\0")
    return h.hexdigest()


def _aligned(off: int) -> int:
    return (off + _ALIGN - 1) // _ALIGN * _ALIGN


def _frame_depth(path) -> np.ndarray:
    depth = np.asarray(load_depth(path))
    return depth[..., 0] if depth.ndim == 3 else depth


def pack_scene(rgb_paths: Sequence, depth_paths: Sequence,
               out_path: Union[str, Path],
               canvas_hw: Optional[Tuple[int, int]] = None,
               depth_dtype: str = "u16mm",
               progress: Union[bool, Callable[[int, int], None]] = False
               ) -> Path:
    """Decode a scene's PNG/npy frames into one ``.avpack`` file, frame by
    frame (constant memory), with the resized LSeg canvas when
    ``canvas_hw`` is given.  ``depth_dtype``: ``"u16mm"`` (uint16
    millimetres) or ``"f32"`` (the npy metres).  Returns ``out_path``."""
    if len(rgb_paths) != len(depth_paths):
        raise ValueError(f"{len(rgb_paths)} rgb vs {len(depth_paths)} depth")
    if depth_dtype not in ("u16mm", "f32"):
        raise ValueError(f"depth_dtype {depth_dtype!r}")
    n = len(rgb_paths)
    if n == 0:
        raise ValueError("empty scene")
    h, w = _frame_depth(depth_paths[0]).shape

    d_item = 2 if depth_dtype == "u16mm" else 4
    sections = {}
    header = {
        "n": n, "h": h, "w": w,
        "canvas_hw": list(canvas_hw) if canvas_hw else None,
        "depth_dtype": depth_dtype,
        "names_sha1": _paths_digest(rgb_paths),
        "sections": sections,
    }
    # a fixed-size header block (magic + u64 length + padded JSON), sized
    # before the section offsets are known, as the JAX writer sizes it
    off = _aligned(len(MAGIC) + 8 + len(json.dumps(header)) + 512)
    sections["rgb"] = off
    off = _aligned(off + n * h * w * 3)
    sections["depth"] = off
    off = _aligned(off + n * h * w * d_item)
    if canvas_hw:
        sections["canvas"] = off
        off = _aligned(off + n * canvas_hw[0] * canvas_hw[1] * 3)

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:
        f.truncate(off)
    rgb_mm = np.memmap(out_path, np.uint8, "r+", sections["rgb"],
                       (n, h, w, 3))
    dt = np.uint16 if depth_dtype == "u16mm" else np.float32
    dep_mm = np.memmap(out_path, dt, "r+", sections["depth"], (n, h, w))
    can_mm = None
    if canvas_hw:
        can_mm = np.memmap(out_path, np.uint8, "r+", sections["canvas"],
                           (n, canvas_hw[0], canvas_hw[1], 3))
    for i in range(n):
        rgb = load_rgb(rgb_paths[i])
        if rgb.shape[:2] != (h, w):
            raise ValueError(f"frame {i}: {rgb.shape[:2]} != {(h, w)}")
        depth = _frame_depth(depth_paths[i])
        rgb_mm[i] = rgb
        if depth_dtype == "u16mm":
            dep_mm[i] = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        else:
            dep_mm[i] = depth.astype(np.float32)
        if can_mm is not None:
            can_mm[i] = resize_canvas_u8(rgb, canvas_hw[0], canvas_hw[1])
        if callable(progress):
            progress(i + 1, n)
        elif progress:
            print(f"\rpacking {i + 1}/{n}", end="", flush=True)
    if progress is True:
        print()
    for mm in (rgb_mm, dep_mm, can_mm):
        if mm is not None:
            mm.flush()
    del rgb_mm, dep_mm, can_mm

    blob = json.dumps(header).encode()
    with open(out_path, "r+b") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(blob)).tobytes())
        f.write(blob)
    return out_path


class PackedScene:
    """Read-only memmap views over an ``.avpack`` file."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not an avpack file")
            (blob_len,) = np.frombuffer(f.read(8), np.uint64)
            meta = json.loads(f.read(int(blob_len)).decode())
        self.meta = meta
        self.n, self.h, self.w = meta["n"], meta["h"], meta["w"]
        self.canvas_hw = (tuple(meta["canvas_hw"])
                          if meta["canvas_hw"] else None)
        self.depth_dtype = meta["depth_dtype"]
        sec = meta["sections"]
        self.rgb = np.memmap(self.path, np.uint8, "r", sec["rgb"],
                             (self.n, self.h, self.w, 3))
        dt = np.uint16 if self.depth_dtype == "u16mm" else np.float32
        self.depth = np.memmap(self.path, dt, "r", sec["depth"],
                               (self.n, self.h, self.w))
        self.canvas = None
        if self.canvas_hw:
            ch, cw = self.canvas_hw
            self.canvas = np.memmap(self.path, np.uint8, "r", sec["canvas"],
                                    (self.n, ch, cw, 3))

    def matches(self, rgb_paths: Sequence) -> bool:
        """True if this pack was built from exactly these frames."""
        return (self.n == len(rgb_paths)
                and self.meta["names_sha1"] == _paths_digest(rgb_paths))


def open_matching(data_dir, rgb_paths: Sequence, depth_paths: Sequence = (),
                  *, explicit_path=None) -> Optional[PackedScene]:
    """Open ``<data_dir>/scene.avpack`` (or ``explicit_path``) iff it was
    packed from exactly these frames and is not older than any of them.
    An implicit candidate that fails warns and returns None (per-frame
    decode); an ``explicit_path`` that fails raises."""
    explicit = explicit_path is not None
    path = (Path(explicit_path) if explicit
            else Path(data_dir) / "scene.avpack")
    if not path.exists():
        if explicit:
            raise FileNotFoundError(path)
        return None
    scene = PackedScene(path)
    msg = None
    if not scene.matches(rgb_paths):
        msg = (f"{path} was packed from a different frame list "
               f"({scene.n} frames vs {len(rgb_paths)})")
    else:
        pack_mtime = path.stat().st_mtime
        newest = max((os.path.getmtime(str(p))
                      for p in list(rgb_paths) + list(depth_paths)),
                     default=0.0)
        if newest > pack_mtime:
            msg = (f"{path} is older than its source frames (scene "
                   "re-rendered?) -- repack it")
    if msg is None:
        return scene
    if explicit:
        raise ValueError(msg)
    print(f"WARNING: ignoring stale pack: {msg}")
    return None


def rgb_reader(data_dir, rgb_paths: Sequence):
    """``callable(i) -> (H, W, 3) uint8 RGB``: read from the memmap when a
    matching ``<data_dir>/scene.avpack`` exists, else a per-frame PNG
    decode, so the one-pass frame encoders (AreaMap) share the pack the
    VLMap builder reads."""
    scene = open_matching(data_dir, rgb_paths)
    if scene is not None:
        return lambda i: np.asarray(scene.rgb[i])
    return lambda i: load_rgb(rgb_paths[i])


class PackedLoader(_QueueLoader):
    """PrefetchLoader twin fed from a PackedScene.

    * ``sampler`` given (the pack carries a canvas): yields
      :class:`CanvasBatch` from the stored canvas plus depth/colour gathers
      at the sampled pixels -- no decode, no resize.
    * ``raw_canvas=True`` (the pack carries a canvas): yields
      :class:`RawCanvasBatch`, the stored canvas and the full-res uint16-mm
      depth plane, both straight memmap copies -- no per-point host work
      (pairs with make_frame_step_device_sampled).
    * otherwise: yields :class:`FrameBatch` with uint8 RGB and the stored
      depth (uint16 mm for a ``u16mm`` pack, which make_frame_step
      rescales on the device), or float32 metres with ``depth_metres=True``
      (for transforms written against the PNG loader's float depth).
    """

    def __init__(self, scene: PackedScene, pose_tfs: Sequence[np.ndarray],
                 batch_size: int = 4, depth: int = 4,
                 skip_ids: Optional[set] = None, sampler=None,
                 transform=None, depth_metres: bool = False,
                 raw_canvas: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if sampler is not None and scene.canvas is None:
            raise ValueError("canvas mode needs a pack built with canvas_hw")
        if raw_canvas:
            if sampler is not None:
                raise ValueError("raw_canvas and sampler are exclusive")
            if scene.canvas is None:
                raise ValueError(
                    "raw_canvas mode needs a pack built with canvas_hw")
        self.scene = scene
        self.pose_tfs = list(pose_tfs)
        self.batch_size = batch_size
        self.skip_ids = skip_ids or set()
        self.sampler = sampler
        self.raw_canvas = raw_canvas
        self.transform = transform
        self.depth_metres = depth_metres
        self.device = torch.device(device) if device is not None else None
        self._queue = queue.Queue(maxsize=depth)
        self._thread = None

    def _n_frames(self) -> int:
        return self.scene.n

    def _make_batch(self, chunk):
        bs = self.batch_size
        ids = list(chunk) + [chunk[-1]] * (bs - len(chunk))
        fids = np.array(list(chunk) + [-1] * (bs - len(chunk)), np.int32)
        pose = np.stack([np.asarray(self.pose_tfs[i], np.float32)
                         for i in ids])
        sc = self.scene
        if self.raw_canvas:
            dep = np.stack([np.asarray(sc.depth[i]) for i in ids])
            if dep.dtype != np.uint16:  # f32-metre pack
                dep = np.clip(dep * 1000.0, 0, 65535).astype(np.uint16)
            return RawCanvasBatch(
                frame_ids=fids,
                canvas=np.stack([np.asarray(sc.canvas[i]) for i in ids]),
                depth_mm=dep, pose_tf=pose)
        if self.sampler is None:
            dep = np.stack([np.asarray(sc.depth[i]) for i in ids])
            if self.depth_metres and dep.dtype == np.uint16:
                dep = dep.astype(np.float32) / 1000.0
            return FrameBatch(
                frame_ids=fids,
                rgb=np.stack([np.asarray(sc.rgb[i]) for i in ids]),
                depth=dep, pose_tf=pose)
        idx = self.sampler(bs)  # (B, N) int32 flat pixel indices
        z = np.stack([np.asarray(sc.depth[i]).reshape(-1)[idx[b]]
                      for b, i in enumerate(ids)])
        if sc.depth_dtype == "u16mm":
            z_mm = z
        else:
            z_mm = np.clip(z * 1000.0, 0, 65535).astype(np.uint16)
        rgb_pts = np.stack([np.asarray(sc.rgb[i]).reshape(-1, 3)[idx[b]]
                            for b, i in enumerate(ids)])
        canvas = np.stack([np.asarray(sc.canvas[i]) for i in ids])
        return CanvasBatch(frame_ids=fids, canvas=canvas, z_mm=z_mm,
                           rgb_pts=rgb_pts, sample_idx=idx.astype(np.int32),
                           pose_tf=pose)
