"""Whole VLMap builds, back to back: ``VLMapBuilder.create_mobile_base_map``
with its final save, each into a fresh directory, from the packed
sequence (as ``create_map --pack-first`` builds).  The sequence walks the rendered scene ``walk:
{"passes": p}`` times, there and back (``data/scene.py``; one pass
without the key).

Window: builds start while less than ``--seconds`` have passed since the
first one started; ``build_fps`` is the frames of all those builds over
the time from the first start to the last end.  Traced segment: one more
build.  Check: the last window build's map against the reference build
(``reference/vlmap.py``) of the same frames, weights and draws.
"""

from __future__ import annotations

import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench.data import scene as scene_data
from portbench.reference import judge
from portbench.reference import vlmap as ref_vlmap


def _map_config(m: dict):
    from avlmaps_torch.config import MapConfig, PoseInfo

    pi = m["pose_info"]
    return MapConfig(
        pose_info=PoseInfo(camera_height=pi["camera_height"],
                           base2cam_rot=tuple(pi["base2cam_rot"]),
                           base_forward_axis=tuple(pi["base_forward_axis"]),
                           base_left_axis=tuple(pi["base_left_axis"]),
                           base_up_axis=tuple(pi["base_up_axis"])),
        cam_calib_mat=tuple(m["cam_calib_mat"]), grid_size=m["grid_size"],
        cell_size=m["cell_size"], depth_sample_rate=m["depth_sample_rate"],
        capacity=m["capacity"], min_depth=m["min_depth"],
        max_depth=m["max_depth"], lseg_base_size=m["lseg_base_size"],
        lseg_crop_size=m["lseg_crop_size"], transport="canvas",
        lseg_eval=m["lseg_eval"])


def setup(ctx):
    cfg, wl = ctx.cfg, ctx.workload
    m = cfg["map"]
    h, w = m["image_hw"]
    canvas = ref_vlmap.plan_windows(h, w, m["lseg_base_size"],
                                    m["lseg_crop_size"])[:2]
    sc = sequence(ctx, canvas)
    # the window's first build reads the page cache as the rest do
    scene_data.read_through(sc["pack"])
    sd = cfg["module"].draw_lseg(cfg, ctx.seed, ctx.device)
    net = cfg["module"].lseg_net(cfg, sd, ctx.device)
    b2c, bt = scene_data.base_transforms(m["pose_info"])
    st = SimpleNamespace(sd=sd, net=net, scene=sc, b2c=b2c, bt=bt,
                         map_config=_map_config(m), last=None, n=0)
    build(st, ctx)  # every shape the window runs
    return st


def sequence(ctx, pack_canvas_hw) -> dict:
    """The cell's frame sequence, its walk over the rendered scene
    (written on the first run in a checkout); ``src`` maps each entry to
    its rendered frame."""
    wl = ctx.workload
    root = ctx.cache / "scenes"
    sc = scene_data.ensure_scene(root, wl["scene"], ctx.cfg["map"],
                                 ctx.device)
    return scene_data.ensure_walk(root, sc,
                                  wl.get("walk", {}).get("passes", 1),
                                  pack_canvas_hw)


def build(st, ctx):
    """One build with its final save, in a fresh directory that is
    removed after; returns (map, frames)."""
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    sc = st.scene
    out = ctx.tmp / f"build-{st.n}"
    st.n += 1
    net = st.net
    b = VLMapBuilder(
        sc["dir"], st.map_config, sc["dir"] / "poses.txt", sc["rgb"],
        sc["depth"], st.b2c, st.bt,
        lseg_apply=lambda x: net(x, upsample=False),
        feat_dim=ctx.cfg["encoder"]["out_dim"],
        batch_size=ctx.cfg["map"]["batch_size"], seed=ctx.seed,
        half_res_apply=True, transport="canvas",
        packed_path=sc["pack"], sampling="host",
        device=ctx.device, map_save_dir=out)
    m = b.create_mobile_base_map(save_every=0, progress=False)
    shutil.rmtree(out, ignore_errors=True)
    return m, b.build_stats["frames"]


def window(st, ctx) -> dict:
    frames = builds = 0
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    while True:
        with record_function("bench.build"):
            m, f = build(st, ctx)
        frames += f
        builds += 1
        st.last = m
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    return {"metrics": {"build_fps": frames / wall},
            "attempted": builds, "failed": 0,
            "counts": {"frames": frames, "builds": builds, "wall_s": wall}}


def traced(st, ctx) -> dict:
    with record_function("bench.build"):
        _, f = build(st, ctx)
    return {"frames": f, "crops": f * ctx.cfg["module"].crops_per_frame(
        ctx.cfg), "steps": -(-f // ctx.cfg["map"]["batch_size"])}


def free(st) -> None:
    st.net = None


def reference(st, ctx, precision: str = "f32") -> dict:
    """The reference map of the judged build's frames, weights and
    draws, with LSeg's products in ``precision``."""
    cfg = ctx.cfg
    return ref_vlmap.build(scene_data.load_frames(st.scene["frames"]),
                           st.scene["src"], st.scene["poses"], cfg["map"],
                           cfg["module"].reference_spec(cfg), st.sd,
                           ctx.seed, cfg["map"]["batch_size"], precision,
                           ctx.device)


def outputs(st, ctx) -> dict:
    """The judged build's map, keyed by voxel."""
    m = st.last
    mc = st.map_config
    return judge.port_map(np.asarray(m.grid_pos), np.asarray(m.weight),
                          np.asarray(m.grid_feat), np.asarray(m.grid_rgb),
                          mc.gs, mc.vh)


def numbers(got: dict, ref: dict, ctx=None, st=None) -> dict:
    """``map_gap`` is compared; its parts are printed beside it."""
    return judge.map_gaps(got, ref)


CONTROL = "fp8"  # the precision below the encoder's bf16
