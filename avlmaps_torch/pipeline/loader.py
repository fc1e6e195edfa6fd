"""Host-side frame pipeline: decode and batch on a producer thread.

Counterpart of ``avlmaps_tpu/pipeline/loader.py`` (reference: one frame at
a time inline with inference, avlmaps/map/vlmap_builder.py:118-120).  With
a ``device``, the producer thread also copies each batch to it --
``pin_memory()`` then ``.to(device, non_blocking=True)`` -- so the
host->device copy overlaps the next batch's decode.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclass
class FrameBatch:
    """One host-side batch of frames."""

    frame_ids: np.ndarray  # (B,) int32, -1 for padding frames
    rgb: np.ndarray  # (B, H, W, 3) uint8, or float32 normalised to [-1, 1]
    depth: np.ndarray  # (B, H, W) float32 metres
    pose_tf: np.ndarray  # (B, 4, 4) float32 point-cloud transform (cam->map)


def load_rgb(path) -> np.ndarray:
    """BGR png -> RGB uint8 (reference vlmap_builder.py:118-119)."""
    if cv2 is not None:
        bgr = cv2.imread(str(path))
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_depth(path) -> np.ndarray:
    """npy depth (reference mapping_utils.py load_depth_npy)."""
    with open(path, "rb") as f:
        return np.load(f)


def batch_to_device(batch, device: torch.device):
    """A copy of a Frame/Canvas/RawCanvasBatch whose payload arrays are
    tensors on ``device``; ``frame_ids`` stays host numpy for the control
    loop.  uint16 arrays cross as their int16 bit pattern and are widened
    to int32 on the device (torch has no general uint16 kernels)."""
    moved = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if f.name == "frame_ids" or not isinstance(v, np.ndarray):
            continue
        u16 = v.dtype == np.uint16
        t = torch.from_numpy(np.ascontiguousarray(v.view(np.int16) if u16
                                                  else v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        t = t.to(device)
        if u16:
            t = t.to(torch.int32) & 0xFFFF
        moved[f.name] = t
    return dataclasses.replace(batch, **moved)


class _QueueLoader:
    """Producer-thread plumbing: chunk frame ids into fixed-size batches on
    a bounded queue, apply ``transform`` and the device copy on the
    producer thread, re-raise producer failures in the consumer.
    Subclasses implement ``_n_frames()`` and ``_make_batch(chunk)`` (which
    pads to ``batch_size`` with repeats, frame_id = -1)."""

    batch_size: int
    skip_ids: set
    transform = None
    device: Optional[torch.device] = None
    _queue: "queue.Queue"

    def _n_frames(self) -> int:
        raise NotImplementedError

    def _make_batch(self, chunk):
        raise NotImplementedError

    def _producer(self):
        try:
            ids = [i for i in range(self._n_frames())
                   if i not in self.skip_ids]
            bs = self.batch_size
            for start in range(0, len(ids), bs):
                batch = self._make_batch(ids[start:start + bs])
                if self.transform is not None:
                    batch = self.transform(batch)
                if self.device is not None:
                    batch = batch_to_device(batch, self.device)
                self._queue.put(batch)
            self._queue.put(None)
        except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
            # a dead producer must not leave the consumer blocked forever
            self._queue.put(exc)

    def __iter__(self) -> Iterator:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            # the consumer waiting on the producer: once a batch and once
            # for the end marker
            with record_function("build.wait_input"):
                batch = self._queue.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise RuntimeError("frame producer thread failed") from batch
            yield batch

    def __len__(self) -> int:
        n = len([i for i in range(self._n_frames())
                 if i not in self.skip_ids])
        return (n + self.batch_size - 1) // self.batch_size


class PrefetchLoader(_QueueLoader):
    """Bounded-queue background prefetcher yielding fixed-size batches; the
    last batch is padded with repeats (frame_id = -1).

    ``normalize=False`` ships raw uint8 RGB (the canvas transport's input);
    ``transform`` (e.g. pipeline.transport.make_canvas_transform) runs on
    the producer thread; ``device`` moves each batch there on the producer
    thread."""

    def __init__(self, rgb_paths: Sequence, depth_paths: Sequence,
                 pose_tfs: Sequence[np.ndarray], batch_size: int = 4,
                 depth: int = 4, normalize=None,
                 skip_ids: Optional[set] = None, transform=None,
                 device: Optional[Union[str, torch.device]] = None):
        from avlmaps_torch.models.lseg.window import normalize_image

        self.rgb_paths = list(rgb_paths)
        self.depth_paths = list(depth_paths)
        self.pose_tfs = list(pose_tfs)
        self.batch_size = batch_size
        self.normalize = normalize_image if normalize is None else normalize
        self.skip_ids = skip_ids or set()
        self.transform = transform
        self.device = torch.device(device) if device is not None else None
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None

    def _frame(self, i: int):
        rgb = load_rgb(self.rgb_paths[i])
        if self.normalize is not False:
            rgb = self.normalize(rgb).astype(np.float32)
        depth = load_depth(self.depth_paths[i])
        if depth.ndim == 3:
            depth = depth[..., 0]
        return (rgb, depth.astype(np.float32),
                np.asarray(self.pose_tfs[i], np.float32))

    def _n_frames(self) -> int:
        return len(self.rgb_paths)

    def _make_batch(self, chunk) -> FrameBatch:
        bs = self.batch_size
        frames = [self._frame(i) for i in chunk]
        while len(frames) < bs:  # pad with repeats, marked invalid
            frames.append(frames[-1])
        fids = np.array(list(chunk) + [-1] * (bs - len(chunk)), np.int32)
        return FrameBatch(
            frame_ids=fids,
            rgb=np.stack([f[0] for f in frames]),
            depth=np.stack([f[1] for f in frames]),
            pose_tf=np.stack([f[2] for f in frames]),
        )


def load_pose(path):
    """Single-line ``px py pz qx qy qz qw`` pose file -> (pos (3, 1), rot
    (3, 3)) (reference mapping_utils.load_pose, :75-85)."""
    from avlmaps_torch.geometry.transforms import quat_xyzw_to_matrix

    with open(path) as f:
        row = [float(x) for x in f.readline().split()]
    pos = np.asarray(row[:3], float).reshape(3, 1)
    return pos, quat_xyzw_to_matrix(np.asarray(row[3:], float))


def load_calib(path) -> np.ndarray:
    """ROS-style camera-calibration YAML -> 3x3 f32 intrinsics (reference
    mapping_utils.load_calib, :64-72: skips the first two header lines)."""
    import yaml

    with open(path) as f:
        f.readline()
        f.readline()
        data = yaml.safe_load(f)
    arr = data["camera_matrix"]["data"]
    return np.asarray([float(x) for x in arr], np.float32).reshape(3, 3)


def load_obj2cls_dict(path) -> dict:
    """``obj_id: cls_id, cls_name`` lines -> {obj_id: (cls_id, name)}
    (reference mapping_utils.load_obj2cls_dict, :625-635): the semantic
    object -> class remap."""
    out = {}
    with open(path) as f:
        for line in f:
            row = line.split(":")
            if len(row) < 2:
                continue
            cls_id, cls_name = row[1].split(",")[:2]
            out[int(row[0])] = (int(cls_id.strip()), cls_name.strip())
    return out
