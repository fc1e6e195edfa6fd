"""Whole area-map builds, back to back: ``AreaMap.create_map`` over the
packed frames of the scene (the pack is found beside the frames, as
``rgb_reader`` looks for it), each into a fresh directory.

Window: builds start while less than ``--seconds`` have passed since the
first one started; ``build_fps`` is their frames over the time from the
first start to the last end.  Traced segment: one more build.  Check:
the last window build's features against the reference CLIP image tower
on the same frames (``reference/clip.py``).
"""

from __future__ import annotations

import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench.data import scene as scene_data
from portbench.reference import clip as ref_clip
from portbench.reference import judge
from portbench.reference import vlmap as ref_vlmap
from portbench.reference.precision import Precision

CONTROL = "tf32"  # the precision below the image tower's f32


def setup(ctx):
    cfg, wl = ctx.cfg, ctx.workload
    m = wl["scene_map"]
    h, w = m["image_hw"]
    canvas = ref_vlmap.plan_windows(h, w, m["lseg_base_size"],
                                    m["lseg_crop_size"])[:2]
    sc = scene_data.ensure_scene(ctx.cache / "scenes", wl["scene"], m,
                                 ctx.device, pack_canvas_hw=canvas)
    sd = cfg["module"].draw_clip(cfg, ctx.seed, ctx.device)
    enc = cfg["module"].clip_encoder(cfg, sd, ctx.device)
    st = SimpleNamespace(sd=sd, enc=enc, scene=sc, last=None, n=0)
    build(st, ctx)  # every shape the window runs
    return st


def _data_dir(st, ctx):
    """A fresh directory that holds the scene's frames, poses and pack
    (links), and receives the area map."""
    d = ctx.tmp / f"area-{st.n}"
    st.n += 1
    d.mkdir(parents=True)
    src = st.scene["dir"]
    os.symlink(src / "rgb", d / "rgb")
    os.symlink(src / "poses.txt", d / "poses.txt")
    os.symlink(st.scene["pack"], d / "scene.avpack")
    return d


def build(st, ctx):
    from avlmaps_torch.map.area_map import AreaMap

    d = _data_dir(st, ctx)
    am = AreaMap(clip_encoder=st.enc, device=ctx.device)
    am.create_map(d, batch_size=ctx.cfg["area"]["batch_size"])
    shutil.rmtree(d, ignore_errors=True)
    return am.clip_sparse_map


def window(st, ctx) -> dict:
    frames = builds = 0
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    while True:
        with record_function("bench.area_build"):
            feats = build(st, ctx)
        frames += feats.shape[0]
        builds += 1
        st.last = feats
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    return {"metrics": {"build_fps": frames / wall},
            "attempted": builds, "failed": 0,
            "counts": {"frames": frames, "builds": builds, "wall_s": wall}}


def traced(st, ctx) -> dict:
    with record_function("bench.area_build"):
        feats = build(st, ctx)
    return {"frames": feats.shape[0]}


def free(st) -> None:
    st.enc = None


def outputs(st, ctx) -> np.ndarray:
    return np.asarray(st.last)


def reference(st, ctx, precision: str = "f32", chunk: int = 32):
    """L2-normalised reference features of the scene's frames."""
    v = ctx.cfg["text"]["vision"]
    rgb, _ = scene_data.load_frames(st.scene)
    p = Precision(precision)
    out = []
    for s in range(0, len(rgb), chunk):
        x = torch.from_numpy(ref_clip.preprocess(rgb[s:s + chunk],
                                                 v["image_size"]))
        f = ref_clip.encode_image(st.sd, x.to(ctx.device), v["patch_size"], p)
        out.append((f / f.norm(dim=-1, keepdim=True)).cpu().numpy())
    return np.concatenate(out)


def numbers(got, ref, ctx=None, st=None) -> dict:
    """``feature_gap``: the largest relative L2 gap of a frame's
    feature."""
    return {"feature_gap": judge.feature_gap(got, ref)}
