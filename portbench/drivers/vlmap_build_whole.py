"""Whole VLMap builds as ``vlmap_build`` makes them, with three settings
from the workload file: ``lseg_eval`` (``"whole"``: one LSeg forward over
the padded canvas), ``sampling`` (``"device"``: the pixels drawn on the
card from threefry bits, ``VLMapBuilder(sampling="device")``) and
``batch_size``.  Window, traced segment and check as ``vlmap_build``'s;
the reference is ``reference/vlmap_whole.py``.

The device sampler's key takes a seed in [0, 2**31) (``PRNGKey``'s
range): a build draws with the run's seed modulo 2**31, and the
reference with the same.
"""

from __future__ import annotations

import shutil
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from portbench.bench import registry
from portbench.data import scene as scene_data
from portbench.reference import vlmap as ref_vlmap
from portbench.reference import vlmap_whole as ref_whole

CONTROL = "fp8"  # the precision below the encoder's bf16
BUILD = registry.driver("vlmap_build")
outputs, numbers, free = BUILD.outputs, BUILD.numbers, BUILD.free


def sampler_seed(seed: int) -> int:
    return seed % 2 ** 31


def setup(ctx):
    cfg, wl = ctx.cfg, ctx.workload
    m = cfg["map"]
    h, w = m["image_hw"]
    canvas = ref_vlmap.plan_windows(h, w, m["lseg_base_size"],
                                    m["lseg_crop_size"])[:2]
    sc = BUILD.sequence(ctx, canvas)
    scene_data.read_through(sc["pack"])
    sd = cfg["module"].draw_lseg(cfg, ctx.seed, ctx.device)
    net = cfg["module"].lseg_net(cfg, sd, ctx.device)
    b2c, bt = scene_data.base_transforms(m["pose_info"])
    st = SimpleNamespace(sd=sd, net=net, scene=sc, b2c=b2c, bt=bt,
                         map_config=BUILD._map_config(
                             dict(m, lseg_eval=wl["lseg_eval"])),
                         last=None, n=0)
    build(st, ctx)  # every shape the window runs
    return st


def build(st, ctx):
    """One build with its final save, in a fresh directory that is
    removed after; returns (map, frames)."""
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    sc, wl = st.scene, ctx.workload
    out = ctx.tmp / f"build-{st.n}"
    st.n += 1
    net = st.net
    b = VLMapBuilder(
        sc["dir"], st.map_config, sc["dir"] / "poses.txt", sc["rgb"],
        sc["depth"], st.b2c, st.bt,
        lseg_apply=lambda x: net(x, upsample=False),
        feat_dim=ctx.cfg["encoder"]["out_dim"],
        batch_size=wl["batch_size"], seed=sampler_seed(ctx.seed),
        half_res_apply=True, transport="canvas", packed_path=sc["pack"],
        sampling=wl["sampling"], device=ctx.device, map_save_dir=out)
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
    return {"frames": f}


def reference(st, ctx, precision: str = "f32") -> dict:
    """The reference map of the judged build's frames, weights and
    draws, with LSeg's products in ``precision``."""
    cfg = ctx.cfg
    return ref_whole.build(scene_data.load_frames(st.scene["frames"]),
                           st.scene["src"], st.scene["poses"], cfg["map"],
                           cfg["module"].reference_spec(cfg), st.sd,
                           sampler_seed(ctx.seed), precision, ctx.device)
