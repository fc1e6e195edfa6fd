"""Row-sharded multi-device voxel fusion with data-parallel encoder frames.

Counterpart of ``avlmaps_tpu/parallel/sharded.py``.  LSeg runs
data-parallel over the frames; each shard extracts a compact per-point
payload (grid row/col/h, feature, rgb, alpha, valid), the payload reaches
every shard (all-gather) or only its owner (all-to-all), and each shard
fuses only the points whose top-down row falls in its slice of the grid.
Slot allocation is per shard, so no cross-shard ordering exists: the
merge on export is concatenation with row and slot offsets.

The JAX package runs one program over a ``Mesh`` of devices with
``shard_map``.  The port keeps that single-controller model: a
:class:`Mesh` is a list of torch devices, each shard's work is enqueued on
its own device from this one process, and the collectives are
device-to-device copies (``Tensor.to(dev, non_blocking=True)``) and
concatenation in device order.  A mesh may name one device several times
(virtual shards, the counterpart of the JAX package's virtual CPU
devices), so the whole sharded program runs on one card or on the CPU.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlmaps_torch.map.vlmap_builder import (_canvas_features, make_unproject,
                                             own_rows)
from avlmaps_torch.models.lseg.window import features_at_points
from avlmaps_torch.ops.voxel_fusion import (ACCUM_PAD, VoxelFusionState,
                                            _device_export, export_bucket,
                                            fuse_points, init_fusion_state,
                                            occupied_from_grid_pos)
from avlmaps_torch.utils.device import resolve_device, to_device

Device = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: ``devices[i]`` holds shard ``i``.  Repeated
    devices are virtual shards."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """The first ``n_devices`` cards (all of them by default; fewer if
    fewer exist, as ``jax.devices()[:n]``), or the explicit ``devices``
    (repeats allowed: virtual shards, e.g. ``["cpu"] * 4`` or
    ``["cuda:0"] * 4``).  Raises without a card when no ``devices`` are
    given."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if n_devices:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), (axis,))


def _on(dev: torch.device):
    """Make ``dev`` current, so the kernels' launches and the current
    stream are that card's."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _per_shard(fn, n: int, what: str) -> List:
    """One callable for every shard, or a sequence with one per shard."""
    if callable(fn):
        return [fn] * n
    fns = list(fn)
    if len(fns) != n:
        raise ValueError(f"{what}: {len(fns)} callables for {n} shards")
    return fns


def _to(a, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``, without a host wait when ``dev`` is a card (host
    arrays cross from pinned memory; a copy to the host stays blocking, so
    its data is there when it returns); uint16 crosses as its int16 bit
    pattern and is widened to int32 on the device (torch has no general
    uint16 kernels)."""
    async_copy = dev.type == "cuda"
    if isinstance(a, np.ndarray) and a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return to_device(bits, dev, non_blocking=async_copy).to(
            torch.int32) & 0xFFFF
    return to_device(a, dev, non_blocking=async_copy)


# the wire payload of one shard: (gid (P, 3) int32, feats (P, D) in the
# payload dtype, rgbs (P, 3) f32, alpha (P,) f32, valid (P,) bool)
Payload = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


class ShardedFusion:
    """Per-shard fusion states and the multi-device map-update step.

    ``payload_dtype``: the wire format of the exchanged features (bf16 by
    default, halving the dominant copy; f32 for bit-level parity with the
    single-device build).  Accumulation stays f32 either way, and the
    round trip through the wire format happens even where source and owner
    are one device, so a virtual and a real mesh build the same map.

    ``transport``: ``"frame"`` feeds full RGB-D frames, ``step(rgb, depth,
    pose, sample_idx, valid)``; ``"canvas"`` the CanvasBatch payload,
    ``step(canvas_u8, z_mm, rgb_pts, pose, sample_idx, valid)``.  uint8
    RGB and uint16 (or integer) millimetre depth are widened on the shard.
    ``lseg_eval="whole"`` needs the canvas transport.

    ``lseg_apply(images) -> features`` and ``geometry_fn(z, sample_idx,
    pose) -> (gid (B, N, 3), fx, fy, alpha, valid)``: one callable, whose
    tensors every shard's device must share, or a sequence with one per
    mesh entry.  Nothing is moved to a shard's device for it: a network on
    another card raises torch's device error.  The default geometry is
    ``vlmap_builder.make_unproject`` on each shard's device.

    ``dedup_scatter``: see ``fuse_points`` (None = K4/K5 on a CUDA shard).

    ``payload_routing``: ``"all_gather"`` sends every point to every
    shard; ``"all_to_all"`` bins the points by owner on the sender and
    sends each owner only its bucket of ``ceil(points / n) * a2a_slack``
    rows (a multiple of 8).  Points past a full bucket are dropped and
    counted in the sending shard's ``n_dropped``.

    Each shard holds ``capacity // n`` slots and ``gs // n`` rows on its
    own device.  A step makes no host synchronisation: bucket sizes come
    from static shapes and only :meth:`export` reads ``n_slots``.
    """

    def __init__(self, mesh: Mesh, *, gs: int, cs: float, vh: int,
                 feat_dim: int, capacity: int, calib_mat: np.ndarray,
                 image_hw: Tuple[int, int], lseg_apply, base_size: int = 520,
                 crop_size: int = 480, min_depth: float = 0.1,
                 max_depth: float = 6.0,
                 payload_dtype: torch.dtype = torch.bfloat16,
                 half_res_apply: bool = False, transport: str = "frame",
                 lseg_eval: str = "sliding", geometry_fn=None,
                 dedup_scatter: Optional[bool] = None,
                 payload_routing: str = "all_gather",
                 a2a_slack: float = 2.0):
        if payload_routing not in ("all_gather", "all_to_all"):
            raise ValueError(f"unknown payload_routing {payload_routing!r}")
        if lseg_eval not in ("sliding", "whole"):
            raise ValueError(f"unknown lseg_eval {lseg_eval!r}")
        if lseg_eval == "whole" and transport != "canvas":
            raise ValueError("lseg_eval='whole' requires canvas transport")
        if transport not in ("frame", "canvas"):
            raise ValueError(f"unknown transport {transport!r}")
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_dev = mesh.size
        if gs % self.n_dev:
            raise ValueError(f"gs={gs} not divisible by {self.n_dev} devices")
        self.gs, self.cs, self.vh = gs, cs, vh
        self.rows_per_dev = gs // self.n_dev
        self.cap_per_dev = capacity // self.n_dev
        self.feat_dim = feat_dim
        self.payload_dtype = payload_dtype
        self.half_res_apply = half_res_apply
        self.transport = transport
        self.lseg_eval = lseg_eval
        self.base_size, self.crop_size = base_size, crop_size
        self.dedup_scatter = dedup_scatter
        self.payload_routing = payload_routing
        self.a2a_slack = a2a_slack
        self._lseg = _per_shard(lseg_apply, self.n_dev, "lseg_apply")
        if geometry_fn is None:
            made = {}
            for dev in self.devices:
                if dev not in made:
                    made[dev] = make_unproject(
                        gs=gs, cs=cs, vh=vh, calib_mat=calib_mat,
                        image_hw=image_hw, base_size=base_size,
                        crop_size=crop_size, min_depth=min_depth,
                        max_depth=max_depth, device=dev)
            self._geometry = [made[dev] for dev in self.devices]
        else:
            self._geometry = _per_shard(geometry_fn, self.n_dev,
                                        "geometry_fn")
        self.states = self._init_states()

    def _init_states(self) -> List[VoxelFusionState]:
        return [init_fusion_state(self.gs, self.vh, self.feat_dim,
                                  self.cap_per_dev, device=dev,
                                  n_rows=self.rows_per_dev)
                for dev in self.devices]

    def restore(self, grid_feat: np.ndarray, grid_pos: np.ndarray,
                weight: np.ndarray, occupied_ids: np.ndarray,
                grid_rgb: Optional[np.ndarray] = None) -> None:
        """Resume from a saved (merged) map: re-shard its slots by row
        ownership, the inverse of :meth:`export` (reference resume
        semantics, avlmaps/map/vlmap_builder.py:66-91)."""
        self.states = restore_sharded(
            grid_feat, grid_pos, weight, occupied_ids, grid_rgb,
            n_dev=self.n_dev, gs=self.gs, vh=self.vh,
            rows_per_dev=self.rows_per_dev, cap_per_dev=self.cap_per_dev,
            feat_dim=self.feat_dim, devices=self.devices)

    # -- one step ------------------------------------------------------------

    def step(self, *args) -> List[VoxelFusionState]:
        """One multi-device map update over a global frame batch, split
        into contiguous blocks of frames in device order (its size must be
        a multiple of the mesh size).

        frame transport:  step(rgb, depth, pose, sample_idx, valid)
        canvas transport: step(canvas_u8, z_mm, rgb_pts, pose, sample_idx,
                               valid)

        Arguments are host arrays or tensors on any device."""
        payloads = self.payloads(*args)
        received, overflow = self.exchange(payloads)
        for j, dev in enumerate(self.devices):
            with _on(dev):
                self._fuse_owned(j, *received[j])
                if overflow[j] is not None:
                    st = self.states[j]
                    st.n_dropped = st.n_dropped + overflow[j]
        return self.states

    def payloads(self, *args) -> List[Payload]:
        """Each shard's wire payload for its block of the batch."""
        b = args[0].shape[0]
        if b % self.n_dev:
            raise ValueError(f"batch {b} is not a multiple of the "
                             f"{self.n_dev}-device mesh")
        per = b // self.n_dev
        body = (self._body_canvas if self.transport == "canvas"
                else self._body_frame)
        out = []
        for i, dev in enumerate(self.devices):
            block = [_to(a[i * per:(i + 1) * per], dev) for a in args]
            with _on(dev):
                gid, feats, rgbs, alpha, valid = body(i, *block)
                d = feats.shape[-1]
                out.append((gid.reshape(-1, 3),
                            feats.reshape(-1, d).to(self.payload_dtype),
                            rgbs.reshape(-1, 3).to(torch.float32),
                            alpha.reshape(-1), valid.reshape(-1)))
        return out

    def _body_frame(self, i: int, rgb, depth, pose, sample_idx, frame_valid):
        if not rgb.is_floating_point():  # raw uint8 frames off the loader
            rgb = rgb.to(torch.float32) * (1.0 / 127.5) - 1.0
        if not depth.is_floating_point():  # millimetres
            depth = depth.to(torch.float32) * 1e-3
        b = rgb.shape[0]
        idx = sample_idx.long()
        z = torch.gather(depth.reshape(b, -1), 1, idx)
        gid, fx, fy, alpha, valid = self._geometry[i](z, sample_idx, pose)
        feats = features_at_points(self._lseg[i], rgb, fx, fy,
                                   self.base_size, self.crop_size,
                                   half_res_apply=self.half_res_apply)
        rgb_u8 = (rgb * 0.5 + 0.5) * 255.0
        rgbs = torch.gather(rgb_u8.reshape(b, -1, 3), 1,
                            idx[..., None].expand(-1, -1, 3))
        return gid, feats, rgbs, alpha, valid & frame_valid[:, None]

    def _body_canvas(self, i: int, canvas_u8, z_mm, rgb_pts, pose,
                     sample_idx, frame_valid):
        canvas = canvas_u8.to(torch.float32) * (1.0 / 127.5) - 1.0
        z = z_mm.to(torch.float32) * 1e-3
        gid, fx, fy, alpha, valid = self._geometry[i](z, sample_idx, pose)
        feats = _canvas_features(self._lseg[i], self.lseg_eval, canvas, fx,
                                 fy, self.base_size, self.crop_size,
                                 self.half_res_apply)
        return gid, feats, rgb_pts, alpha, valid & frame_valid[:, None]

    # -- the collectives -----------------------------------------------------

    def exchange(self, payloads: Sequence[Payload]
                 ) -> Tuple[List[Payload], List[Optional[torch.Tensor]]]:
        """The payload each shard fuses, with features back in f32, and
        each shard's send-side drops (None under all-gather)."""
        if self.payload_routing == "all_to_all":
            sent, overflow = zip(*(self._buckets(p) for p in payloads))
            cap = sent[0][0].shape[0] // self.n_dev
            parts = [[tuple(x[j * cap:(j + 1) * cap] for x in s)
                      for s in sent] for j in range(self.n_dev)]
        else:
            overflow = [None] * self.n_dev
            parts = [list(payloads)] * self.n_dev
        received = []
        for j, dev in enumerate(self.devices):
            with _on(dev):
                cols = [torch.cat([_to(p[k], dev) for p in parts[j]])
                        for k in range(5)]
                cols[1] = cols[1].to(torch.float32)
                received.append(tuple(cols))
        return received, list(overflow)

    def _buckets(self, payload: Payload):
        """Bin one shard's payload by owner row range (a stable sort, so
        each bucket keeps the points' order) into ``n_dev`` buckets of
        ``cap`` rows; returns the (n_dev * cap, ...) buckets and the count
        of points that did not fit."""
        gid, feats, rgbs, alpha, valid = payload
        n_dev, rows = self.n_dev, self.rows_per_dev
        dev = gid.device
        with _on(dev):
            n_pts = gid.shape[0]
            cap = int(min(n_pts, -(-n_pts // n_dev) * self.a2a_slack))
            cap = max(8, ((cap + 7) // 8) * 8)
            owner = torch.clamp(gid[:, 0], 0, self.gs - 1) // rows
            owner = torch.where(valid, owner, n_dev)  # invalid -> sentinel
            order = torch.argsort(owner, stable=True)
            so = owner[order]
            start = torch.searchsorted(
                so, torch.arange(n_dev + 1, dtype=so.dtype, device=dev))
            pos = torch.arange(n_pts, device=dev) - start[so.long()]
            keep = (so < n_dev) & (pos < cap)
            dst = torch.where(keep, so * cap + pos, n_dev * cap).long()

            def bucketize(x):
                out = torch.zeros((n_dev * cap + 1,) + x.shape[1:],
                                  dtype=x.dtype, device=dev)
                out[dst] = x[order]  # the last row takes every drop
                return out[:n_dev * cap]

            overflow = torch.sum((so < n_dev) & ~keep, dtype=torch.int32)
            return tuple(bucketize(x) for x in payload), overflow

    def _fuse_owned(self, j: int, gid, feats, rgbs, alpha, valid) -> None:
        """Rebase global grid ids onto shard ``j``'s rows and fuse the
        rows it owns."""
        rows, gs, vh = self.rows_per_dev, self.gs, self.vh
        vids, owned = own_rows(gid, gs=gs, vh=vh, n_rows=rows,
                               row_offset=j * rows)
        fuse_points(self.states[j], vids, feats, rgbs, alpha, valid & owned,
                    gs=gs, vh=vh, n_rows=rows,
                    dedup_scatter=self.dedup_scatter)

    def export(self):
        return export_sharded(self.states, gs=self.gs, vh=self.vh,
                              rows_per_dev=self.rows_per_dev,
                              cap_per_dev=self.cap_per_dev)


def restore_sharded(grid_feat: np.ndarray, grid_pos: np.ndarray,
                    weight: np.ndarray, occupied_ids: np.ndarray,
                    grid_rgb: Optional[np.ndarray], *, n_dev: int, gs: int,
                    vh: int, rows_per_dev: int, cap_per_dev: int,
                    feat_dim: int,
                    devices: Optional[Sequence[Device]] = None
                    ) -> List[VoxelFusionState]:
    """Per-shard fusion states from a merged map, shard ``d`` on
    ``devices[d]`` (default: ``"cuda"`` for every shard).

    Each slot goes to the shard whose row range holds its grid row; a
    shard's slots are renumbered in their saved order, and its occupied
    table is rebuilt from the slots' own (row, col, h), so stale entries
    of ``occupied_ids`` cannot leak across shards."""
    devices = list(devices) if devices is not None else ["cuda"] * n_dev
    rows = grid_pos[:, 0]
    states = []
    for d in range(n_dev):
        dev = resolve_device(devices[d])
        mine = np.nonzero((rows >= d * rows_per_dev)
                          & (rows < (d + 1) * rows_per_dev))[0]
        k = mine.shape[0]
        if k > cap_per_dev:
            raise ValueError(f"shard {d} needs {k} slots > per-shard "
                             f"capacity {cap_per_dev}")
        w = np.asarray(weight[mine], np.float32)
        acc = np.zeros((cap_per_dev + 1, feat_dim + ACCUM_PAD), np.float32)
        acc[:k, :feat_dim] = grid_feat[mine] * w[:, None]
        if grid_rgb is not None:
            acc[:k, feat_dim:feat_dim + 3] = \
                grid_rgb[mine].astype(np.float32) * w[:, None]
        acc[:k, feat_dim + 3] = w
        lpos = grid_pos[mine].astype(np.int32)
        lpos[:, 0] -= d * rows_per_dev
        acc[:k, feat_dim + 4:feat_dim + 7] = lpos
        occ = np.full((rows_per_dev * gs * vh,), -1, np.int32)
        occ[(lpos[:, 0] * gs + lpos[:, 1]) * vh + lpos[:, 2]] = np.arange(
            k, dtype=np.int32)
        states.append(VoxelFusionState(
            occupied_flat=torch.from_numpy(occ).to(dev),
            accum=torch.from_numpy(acc).to(dev),
            n_slots=torch.tensor(k, dtype=torch.int32, device=dev),
            n_dropped=torch.zeros((), dtype=torch.int32, device=dev)))
    return states


def export_sharded(states: Sequence[VoxelFusionState], *, gs: int, vh: int,
                   rows_per_dev: int, cap_per_dev: int):
    """Merge the shards into the reference's storage form: (grid_feat,
    grid_pos, weight, occupied_ids, grid_rgb), shard by shard in device
    order with each shard's rows rebased, and the dense occupied table
    rebuilt from the positions.

    Each shard finishes its weighted mean on its device for its first
    ``bucket = min(export_bucket(max n_slots), cap + 1)`` slots, so the
    device->host copy scales with occupancy and the occupied tables never
    leave their devices."""
    n_slots = [int(st.n_slots) for st in states]
    bucket = min(export_bucket(max(n_slots)), cap_per_dev + 1)
    feats, poss, weights, rgbs = [], [], [], []
    for d, st in enumerate(states):
        n = n_slots[d]
        with _on(st.accum.device):
            f, p, w, r = (t.cpu().numpy() for t in _device_export(st,
                                                                  bucket))
        feats.append(f[:n])
        p = p[:n].copy()
        p[:, 0] += d * rows_per_dev
        poss.append(p)
        weights.append(w[:n])
        rgbs.append(r[:n])
    grid_pos = np.concatenate(poss).astype(np.int32)
    return (np.concatenate(feats).astype(np.float32), grid_pos,
            np.concatenate(weights).astype(np.float32),
            occupied_from_grid_pos(grid_pos, gs, vh), np.concatenate(rgbs))


def sharded_score_argmax(mesh: Mesh, map_feats, text_feats,
                         normalize_map: bool = True,
                         normalize_text: bool = True) -> np.ndarray:
    """Multi-device open-vocabulary indexing: the (N, D) voxel features
    row-sharded over the mesh (padded to ``n * 8`` rows), the (C, D) text
    replicated; every shard runs K7 (``ops.similarity.score_argmax``) on
    its rows, with no collective.  Returns the (N,) int32 labels on the
    host."""
    from avlmaps_torch.ops.similarity import score_argmax

    n_dev = mesh.size
    feats = map_feats if isinstance(map_feats, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(map_feats, np.float32))
    feats = feats.to(torch.float32)
    n = feats.shape[0]
    pad = (-n) % (n_dev * 8)  # equal shards of whole 8-row groups
    if pad:
        feats = torch.cat([feats, feats.new_zeros((pad, feats.shape[1]))])
    per = feats.shape[0] // n_dev
    text = text_feats if isinstance(text_feats, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(text_feats, np.float32))
    labels = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            shard = _to(feats[i * per:(i + 1) * per], dev).contiguous()
            t = _to(text.to(torch.float32), dev).contiguous()
            labels.append(score_argmax(shard, t, normalize_map=normalize_map,
                                       normalize_text=normalize_text))
    return torch.cat([lab.cpu() for lab in labels]).numpy()[:n]
