"""The image query in a closed loop with one client: ask where a photo
was taken, wait for the pose, ask again.  The entry is
``VisualMap.localize_image`` (what ``AVLMap.index_image`` calls before
its 2-D decay over the voxels): CLIP retrieval over the walk's frames,
SuperPoint on the query, SuperGlue against the retrieved frame's cached
features and its decision; the depth-lifted PnP where 12 pairs pass
(with the configuration's seeded weights none does, and the call returns
the retrieved frame's pose).

Set-up: the cell's rendered scene (shared with the other cells), a
run-local data directory of links to its frames, depth and poses (the
descriptor cache is written there, under ``TMPDIR``), one query image at
every ``query_every``-th walk pose, moved ``offset_m`` in the floor plane
and turned ``yaw_deg`` (either way) from it, drawn from the seed; the
seeded SuperPoint, SuperGlue and CLIP; ``VisualMap`` through its public
constructor and ``create_and_load_map``; each query once as warm-up,
which fills the reference-feature and depth caches as a long-lived map
has them.  Window: each image once per round of the query set, in the
seed's order; a query's latency runs from the call until its (camera tf,
base tf) host arrays return.  Traced segment: half the query set once.

The extractor's, the matcher's and the retrieval's results are recorded
by wrapping the instances' methods: the query's SuperPoint output on the
device, the reference frame's features used, the log assignment Z and
the matches on the device, and the frame picked; the pose is what the
call returns.  A sample of the window's queries drawn from the seed as
they complete, and the last, keep them for the check against
``reference/superglue.py``, ``reference/pose.py`` and
``reference/clip.py``; nothing is copied inside the window.
"""

from __future__ import annotations

import math
import os
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench.data import scene as scene_data
from portbench.reference import clip as ref_clip
from portbench.reference import pose as ref_pose
from portbench.reference import superglue as ref_sg
from portbench.reference.precision import Precision

CONTROL = "tf32"  # the precision below the configuration's f32


def _map_config(m: dict):
    from avlmaps_torch.config import MapConfig, PoseInfo

    pi = m["pose_info"]
    return MapConfig(
        pose_info=PoseInfo(camera_height=pi["camera_height"],
                           base2cam_rot=tuple(pi["base2cam_rot"]),
                           base_forward_axis=tuple(pi["base_forward_axis"]),
                           base_left_axis=tuple(pi["base_left_axis"]),
                           base_up_axis=tuple(pi["base_up_axis"])),
        cam_calib_mat=tuple(m["cam_calib_mat"]))


def query_poses(poses: np.ndarray, wl: dict, seed: int) -> np.ndarray:
    """(n, 7) habitat poses: one at every ``query_every``-th walk pose,
    moved by a distance in ``offset_m`` in a direction in the floor plane
    and turned by an angle in ``yaw_deg`` to either side.  The walk's
    poses turn about the vertical axis alone."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for i in range(0, len(poses), wl["query_every"]):
        v = poses[i].copy()
        r, a = rng.uniform(*wl["offset_m"]), rng.uniform(0.0, 2 * math.pi)
        v[0] += r * math.cos(a)
        v[2] += r * math.sin(a)
        yaw = 2 * math.atan2(v[4], v[6]) + math.radians(
            rng.uniform(*wl["yaw_deg"])) * rng.choice((-1.0, 1.0))
        v[3:] = [0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)]
        out.append(v)
    return np.stack(out)


def render_queries(sc: dict, ctx):
    """The query images (n, H, W, 3) and their habitat poses (n, 7)."""
    wl, m = ctx.workload, ctx.cfg["map"]
    vecs = query_poses(sc["poses"], wl, ctx.seed)
    # the map frame is the walk's first pose's
    tfs = scene_data.cam_to_map(np.concatenate([sc["poses"][:1], vecs]),
                                m["pose_info"])[1:]
    rgb, _ = scene_data.render(tfs, scene_data.calib_matrix(m),
                               tuple(wl["scene"]["hw"]),
                               scene_data.room_layout(wl["scene"]),
                               ctx.device)
    return rgb, vecs


def _data_dir(sc: dict, ctx):
    d = ctx.tmp / "visual"
    d.mkdir(parents=True)
    for name in ("rgb", "depth", "poses.txt"):
        os.symlink(sc["dir"] / name, d / name)
    return d


def _record(sp, sg, vm):
    """Wrap the instances' methods to keep what the last query made."""
    rec = SimpleNamespace(sp=None, ref=None, z=None, hw=None, pick=None,
                          matches=None)
    extract, assign, match, retrieve = sp.extract_device, sg.assignment, \
        sg.match, vm.retrieve

    def extract_device(images):
        rec.sp = extract(images)
        return rec.sp

    def assignment(f0, f1, hw, hw1=None):
        rec.z = assign(f0, f1, hw, hw1)
        rec.ref, rec.hw = f1, (tuple(hw), tuple(hw1 or hw))
        return rec.z

    def match_(f0, f1, hw, hw1=None):
        out = match(f0, f1, hw, hw1)
        rec.matches = out[0]
        return out

    def retrieve_(image, topk=1):
        out = retrieve(image, topk)
        rec.pick = int(out[0])
        return out

    sp.extract_device = extract_device
    sg.assignment = assignment
    sg.match = match_
    vm.retrieve = retrieve_
    return rec


def setup(ctx):
    from avlmaps_torch.map.visual_map import VisualMap

    cfg, wl = ctx.cfg, ctx.workload
    mod = cfg["module"]
    sc = scene_data.ensure_scene(ctx.cache / "scenes", wl["scene"],
                                 cfg["map"], ctx.device)
    images, vecs = render_queries(sc, ctx)
    sds = {"sp": mod.draw_superpoint(cfg, ctx.seed, ctx.device),
           "sg": mod.draw_superglue(cfg, ctx.seed, ctx.device),
           "clip": mod.draw_clip(cfg, ctx.seed, ctx.device)}
    sp = mod.superpoint(cfg, sds["sp"], ctx.device)
    sg = mod.superglue(cfg, sds["sg"], ctx.device)
    d = _data_dir(sc, ctx)
    vm = VisualMap(_map_config(cfg["map"]), str(d),
                   clip_encoder=mod.clip_encoder(cfg, sds["clip"],
                                                 ctx.device),
                   superpoint=sp, superglue=sg, device=ctx.device)
    vm.create_and_load_map(d)
    rec = _record(sp, sg, vm)
    rng = np.random.default_rng([ctx.seed, 2])
    n = len(images)
    order = np.concatenate([rng.permutation(n) for _ in range(1 << 8)])
    st = SimpleNamespace(sds=sds, vm=vm, rec=rec, images=images,
                         query_vecs=vecs, scene=sc, order=order, rng=rng,
                         kept=[])
    for j in range(n):  # every shape the window runs; fills the caches
        vm.localize_image(images[j])
    return st


def _ask(st, j: int):
    with record_function("bench.query"):
        cam, _ = st.vm.localize_image(st.images[j])
    r = st.rec
    return (j, r.pick, r.sp, r.ref, r.z, r.hw, r.matches, cam)


def window(st, ctx) -> dict:
    lat = []
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        ts = time.perf_counter()
        item = _ask(st, int(st.order[n % len(st.order)]))
        te = time.perf_counter()
        lat.append(te - ts)
        _sample(st, n, ctx.workload["checked_queries"] - 1, item)
        last = item
        n += 1
        if te - t0 >= ctx.seconds:
            break
    wall = te - t0
    st.kept.append(last)
    return {"metrics": {"query_p95_ms": float(np.percentile(lat, 95) * 1e3),
                        "query_qps": n / wall},
            "attempted": n, "failed": 0,
            "counts": {"queries": n, "wall_s": wall}}


def _sample(st, n: int, size: int, item) -> None:
    """A uniform sample of ``size`` of the queries so far, drawn from the
    seed (reservoir sampling)."""
    if n < size:
        st.kept.append(item)
        return
    j = int(st.rng.integers(0, n + 1))
    if j < size:
        st.kept[j] = item


def traced(st, ctx) -> dict:
    stats = getattr(st.vm, "stats", None)
    before = dict(stats) if stats is not None else {}
    n = len(st.images) - len(st.images) // 2
    for i in range(n):
        _ask(st, int(st.order[-1 - i]))
    z = st.rec.z
    out = {"queries": n, "K0": z.shape[1] - 1, "K1": z.shape[2] - 1}
    if stats is not None:
        out.update({k: v - before[k] for k, v in stats.items()})
    return out


def free(st) -> None:
    st.vm = None


def _valid(f: dict, dev):
    """The valid keypoints of a (1, K, ...) feature dict, on ``dev``, and
    the validity mask."""
    v = torch.as_tensor(f["valid"])[0].to(dev)
    return {k: torch.as_tensor(f[k])[0].to(dev)[v]
            for k in ("keypoints", "scores", "descriptors")}, v


def outputs(st, ctx) -> list:
    """Each checked query's frame pick, valid keypoints and descriptors,
    Z over the valid rows and columns and the dustbins, the matches
    (valid row -> valid column or -1), and the camera pose returned."""
    dev = ctx.device
    out = []
    for j, pick, sp, ref, z, hw, m, cam in st.kept:
        q, v0 = _valid(sp, dev)
        r, v1 = _valid(ref, dev)
        i0, i1 = v0.nonzero()[:, 0], v1.nonzero()[:, 0]
        rows = torch.cat([i0, torch.tensor([len(v0)], device=dev)])
        cols = torch.cat([i1, torch.tensor([len(v1)], device=dev)])
        col_of = torch.full((len(v1),), -1, dtype=torch.int64, device=dev)
        col_of[i1] = torch.arange(len(i1), device=dev)
        m = m[0].to(dev, torch.int64)[i0]
        out.append({"image": j, "pick": pick, "keypoints": q["keypoints"],
                    "descriptors": q["descriptors"],
                    "z": z[0].to(dev)[rows][:, cols],
                    "matches": torch.where(m >= 0, col_of[m.clamp(min=0)],
                                           m),
                    "pose": np.asarray(cam, np.float64),
                    "inputs": (q, r, hw)})
    return out


def reference(st, ctx, precision: str = "f32", chunk: int = 32) -> list:
    """For each checked query: the reference's cosines to every frame and
    its pick, its SuperPoint keypoints and descriptors of the query, its
    Z given the port's keypoints and descriptors of the query and of the
    frame the port matched it with, and its matches on that Z; the pose
    from the port's matches (the frame's pose where the solve fails), and
    the pose the query was rendered at."""
    cfg = ctx.cfg
    dev = ctx.device
    p = Precision(precision)
    text = cfg["module"].clip_text(cfg)
    v = text["vision"]
    pnp = cfg["pnp"]
    pose_info = cfg["map"]["pose_info"]
    calib = scene_data.calib_matrix(cfg["map"])
    rgb, depth = scene_data.load_frames(st.scene)

    def encode(frames):
        x = torch.from_numpy(ref_clip.preprocess(frames, v["image_size"]))
        f = ref_clip.encode_image(st.sds["clip"], x.to(dev),
                                  v["patch_size"], p)
        return f / f.norm(dim=-1, keepdim=True)

    frames = torch.cat([encode(rgb[s:s + chunk])
                        for s in range(0, len(rgb), chunk)])
    out = []
    for item in outputs(st, ctx):
        img = st.images[item["image"]]
        cos = (frames @ encode(img[None]).T)[:, 0]
        sp = ref_sg.superpoint(st.sds["sp"], torch.from_numpy(
            ref_sg.gray(img)).to(dev), cfg["superpoint"], p)
        q, r, (hw0, hw1) = item["inputs"]
        z = ref_sg.superglue(st.sds["sg"], q, r, hw0, hw1, cfg["superglue"],
                             p)
        m = item["matches"]
        sel = (m >= 0).cpu().numpy()
        frame = item["pick"]
        ref_cam = ref_pose.camera_tf(st.scene["poses"][frame], pose_info)
        pose = ref_pose.pnp_pose(
            r["keypoints"].cpu().numpy()[m.cpu().numpy()[sel]],
            q["keypoints"].cpu().numpy()[sel], depth[frame], calib,
            ref_pose.fov_intrinsics(*img.shape[:2]), ref_cam,
            pnp["min_matches"], pnp["reproj_error_px"], pnp["iterations"])
        out.append({"image": item["image"], "pick": int(torch.argmax(cos)),
                    "cos": cos, "keypoints": sp["keypoints"],
                    "descriptors": sp["descriptors"], "z": z,
                    "matches": ref_sg.matches(
                        z, cfg["superglue"]["match_threshold"]),
                    "pose": ref_cam if pose is None else pose,
                    "truth": ref_pose.camera_tf(
                        st.query_vecs[item["image"]], pose_info)})
    return out


def numbers(got: list, ref: list, ctx=None, st=None) -> dict:
    """``retrieve_gap``: the reference's best frame cosine minus its
    cosine of the answer's pick; ``keypoint_gap``: 1 - the share of the
    reference's keypoints the answer found too; ``descriptor_gap``: the
    largest L2 gap of those shared keypoints' descriptors;
    ``assign_gap``: the largest |Z - Z_ref| over the valid rows and
    columns and the dustbins; ``match_gap``: the rows matched
    differently (over the rows either matches); ``pose_gap``: the
    largest entry of |pose - pose_ref|.  Each the largest over the
    checked queries.  ``pose_error_m``, for information: the median over
    them of the returned camera's distance from where the query was
    rendered."""
    gaps = dict.fromkeys(("retrieve_gap", "keypoint_gap", "descriptor_gap",
                          "assign_gap", "match_gap", "pose_gap"), 0.0)
    errors = []

    def up(k, v):
        gaps[k] = max(gaps[k], float(v))

    for g, r in zip(got, ref):
        up("retrieve_gap", r["cos"].max() - r["cos"][g["pick"]])
        rk = r["keypoints"].long()
        gk = g["keypoints"].to(rk.device).long()
        rid, gid = rk[:, 1] << 16 | rk[:, 0], gk[:, 1] << 16 | gk[:, 0]
        shared = torch.isin(rid, gid)
        up("keypoint_gap", 1.0 - float(shared.float().mean())
           if len(rid) else float(len(gid) > 0))
        if bool(shared.any()):
            d = g["descriptors"].to(rk.device)[_positions(gid, rid[shared])] \
                - r["descriptors"][shared]
            up("descriptor_gap", d.norm(dim=1).max())
        gz = g["z"].to(r["z"].device)
        up("assign_gap", (gz - r["z"]).abs().max()
           if gz.shape == r["z"].shape else math.inf)
        gm, rm = g["matches"].to(r["matches"].device), r["matches"]
        if gm.shape != rm.shape:
            up("match_gap", math.inf)
        else:
            either = (gm >= 0) | (rm >= 0)
            up("match_gap", float((gm != rm).sum()) / max(
                int(either.sum()), 1))
        up("pose_gap", np.abs(g["pose"] - r["pose"]).max())
        errors.append(np.linalg.norm(g["pose"][:3, 3] - r["truth"][:3, 3]))
    gaps["pose_error_m"] = float(np.median(errors)) if errors else 0.0
    return gaps


def _positions(keys: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Index in ``keys`` (unique) of each of ``want`` (all present)."""
    order = torch.argsort(keys)
    return order[torch.searchsorted(keys[order], want)]
