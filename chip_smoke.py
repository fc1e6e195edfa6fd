#!/usr/bin/env python3
"""Smoke run of the avlmaps_torch port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of ``avlmaps_torch/csrc`` (one
   ``nvcc`` per source, all at once) into ``avlmaps_torch/_build``; prints
   each kernel's registers and spill stores from ptxas and fails on a
   spill or on warning C7508 (``setmaxnreg`` ignored).  Switches TF32 off
   for matmul and cuDNN (the port never switches it on; the query phase
   asserts it stays off).  Installs the position gate: after every build
   (and after each fusion step, recorded on the card) every slot position
   lies inside the grid, or the run fails with the step, the slot and its
   neighbours.
2. Kernel checks: K1-K4 at the map-building shapes (4 frames = 8 crops of
   480^2, M = 7208 token rows, 7776 points per frame into a 1e6-slot
   accumulator), and K7/K8 at the serving query's shape (N = 1e6 voxels x
   512 f32, C = 22 categories, again at C = 41, and the tie cases), each
   against its plain PyTorch version on the same inputs, with its
   tolerance; times the kernel, the plain version and one PyTorch library
   call for the same function (a yardstick the port never calls) with
   CUDA events, and the wgmma kernels' device time with the profiler.
3. Slice 1, map construction: writes a synthetic 720x1080 RGB-D scene,
   builds it with ``VLMapBuilder`` and the ViT-L/16 LSeg in bf16 (seeded
   random weights) at gs=1000, cs=0.05, vh=30, capacity 1e6, D=512, batch
   4, canvas transport, sliding-window eval; checks the launch counts
   (K1-K3 24 per forward, K4 one per step), the map, the HDF5 reload, and
   one crop's features against the CPU path of the same network; then K4
   on the warm-up build's real sorted step against its plain version and
   bitwise against K5, with device times and the run-length profile.
4. Slice 2, the object query: the full-width ViT-B/32 CLIP text tower
   (seeded weights) on the card against the port's CPU path; the serving
   query (``make_text_object_query``) at production scale (1e6 voxels x
   512 f32 on a 1000x1000x30 grid, 21 resident categories + the query,
   k = 64): queries/s over 8 words x 3 epochs with async fetches, the
   synchronous latency, goal / top-k / u8 parity with the host heat, a
   run under ``torch.cuda.set_sync_debug_mode("error")`` up to the fetch,
   K7 once per query, and the device ms per stage from ``torch.profiler``;
   then the object query (``AVLMap.index_object``, every delivery,
   ``init_categories`` with K8 once, ``make_serving_query``, ``get_pos``)
   on the map slice 1 built.  Counts are zeroed before each slice's path
   and read after it.
5. Slice 3, the throughput build and the other routes: K6
   (``gelu_matmul``) and K2 on (B, H, T, D) tensors (``mha_bhtd``, the
   flash/splash row) against their plain versions at the ViT-L shapes; a
   64-frame 720x1080 scene packed with ``pack_scene`` (canvas 347x520)
   and built with ``sampling="device"``, whole-canvas eval, batch 16 (K5
   once a step, K4 never; frames/s, host and device ms per step, idle
   share; a warm step under ``set_sync_debug_mode("error")``); the same
   frames through the canvas transport (host sampling, whole, batch 16);
   the frame transport (sliding, batch 4, 2 steps) against the canvas
   transport on the same frames and draws; K5 against its plain version
   bitwise against K4 and bitwise against itself with allocations of the
   batch's size made between its wrapper and its launch (the kernel reads
   only its arguments), on a real 124,416-row sorted batch of the build,
   with the batch's run-length profile; K1, K3 and K2 at the
   throughput build's shapes, and K1 at N = 4096 (the unfused fc);
   8-crop ViT-L taps with ``MLP_FUSE=False`` and ``attn_impl="flash"``
   against the default route; a medium f32 LSeg on the card against the
   CPU.
6. Slice 7, the area and sound queries, on the slice-1 scene: writes its
   ``audio_video/`` (20 sequences of 12 s at 44.1 kHz, 3 noisy tones of
   1.5-2.6 s between exact silences each, 25 fps habitat pose walks);
   the full-width AudioCLIP (ESResNeXt-50 32x4d, n_fft 2048, hop 561,
   win 1654, embed 1024; seeded weights) on one batch of 10 of the sound
   map's 220,500-sample clips against the port's CPU path (cosine >=
   0.9999 and max |d| <= 1e-3 after L2 normalisation, with TF32 switched
   on outside and asserted off inside the forward), and the area map's
   CLIP ViT-L/14 on two frames by the same rule; builds the area map
   (``AreaMap.create_map``) and the sound map
   (``SoundMap.create_sound_map``, one event a tone), then
   ``AVLMap.load_map``; ``index_area_2d`` / ``index_sound_2d`` at gs =
   1000 on the card against the same calls on CPU tensors (atol 1e-5),
   the u8 delivery against the host quantisation, the (N,) lifts, and
   the object query (K8 with ``init_categories`` on the category that
   labels the most voxels, K7 without on 'chair') x area x sound (both
   at decay 0.005 a cell, so the product is positive) fused on the card
   against the host argmax.  K7 and K8 counts
   are zeroed before the phase's path and must read >= 1 after it.
   Prints the events found, the audio tower's clips/s at batch 10 and
   its device ms a batch, the area map's frames/s, each 2D query's
   device ms and kernel launches, and the phase's wall seconds.
7. Slice 8, the image query and the other models, on the slice-1 scene
   (seeded weights at full width): SuperPoint on one 720x1080 frame
   against the CPU (keypoint sets shared >= 99%, scores within 1e-6 and
   descriptors within 1e-4 at shared keypoints; ms an image); SuperGlue
   (9 layer pairs, 100 Sinkhorn iterations) on two frames' 1024 + 1024
   keypoints against the CPU (Z within 1e-3, decisions agreeing on >= 99%
   of the rows; ms, device ms and launches a match); NetVLAD against the
   CPU at 240x320 (cosine >= 0.9999) and the scene's 32 frames at
   720x1080 (frames/s); ``VisualMap.create_and_load_map`` with NetVLAD
   and with the CLIP ViT-B/32 image tower on 16 mosaic frames, where a
   mapping frame must retrieve itself; ``refine_pose`` on the textured
   240x320 canvas with the query moved 25 cm (full-width SuperPoint +
   mutual-NN, on the CPU and on the card: within 6 cm);
   ``AVLMap.load_map`` with the visual map, ``index_image`` equal to the
   host formula, and object (K7; K8 with the categories) x image fused on
   the card against the host argmax (K7 and K8 zeroed first, >= 1 after);
   ``multi_scale_features`` (6 scales with flip) on one 720x1080 frame:
   the medium f32 LSeg against the CPU within 5e-3 and the ViT-L/16 bf16
   LSeg on the card (K1-K3 zeroed first, 24 a forward after; crops and
   ms a frame), each of its forwards again through the fused route and
   the plain route (no port kernel) on the same weights (per-pixel cosine
   >= 0.999), and K1, K3 and K2 at its crop batches that the batch-8 rows
   do not cover (2, 4 and 12 crops: M = 1802, 3604, 10812) against their
   plain versions, with times, bounds and library times; Wav2CLIP on 10 of the sound map's clips against the CPU
   (cosine >= 0.9999).  Every f32 model runs with TF32 switched on
   outside and asserted off inside its forward.  Prints whether OpenCV
   is installed and the phase's wall seconds.
8. Slice 9, the multi-floor build and the robot.  After slice 3, while
   the ViT-L/16 net lives: 32 720x1080 frames with global camera poses
   on two floors 3 m apart (16 a floor) built by
   ``VLMapBuilderMultiFloor`` at batch 8 (16 crops, M = 14,416; 4
   steps; the full sliding-window canvas; K4 once a step); its
   ``probe_bounds`` against a numpy f64 recomputation (1e-5 m); launches
   (K1-K3 24 a forward, K4 once a step, K5 never); host and device ms a
   step and the idle share (a profiled second build); the HDF5 file
   through ``VLMapMultiFloor.load_map``; the same scene built on the
   card and on the CPU with a stand-in network (a seeded f32 1x1
   projection of the RGB to 512 channels): the same voxels
   and slots, weights within rtol 1e-5, features within 1e-5 + 1e-5 x
   |CPU|, and the ViT-L build's voxels equal to the stand-in's; K1, K3
   and K2 at M = 14,416 / (16, 16, 901, 64) against their plain
   versions with times, bounds and library times.  After slice 8:
   ``VLMapMultiFloor.index_map('chair')`` through K7 against the CPU on
   clear rows; ``HabitatLanguageRobot`` with the kinematic simulator on
   the slice-1 scene laid out as ``vlmaps_dataset/<scene>``, on the card
   and on the CPU (whose text features are the card's: the text tower
   is held to the CPU in slice 2) from the same start: ``setup_scene``
   (K8 at C = 41, the customised obstacle map with K7, the native
   visgraph of the gs = 1000 crop), ``move_to_object`` of 'chair' and of
   the category labelling the most voxels (the same target, reachable
   goal and actions; the last action 'stop' within 3 cells of the
   goal), ``get_map_3d`` (atol 1e-5), and ``get_max_pos_3d_fused`` of an
   object and a sound heat on the card under
   ``set_sync_debug_mode("error")`` up to its fetch, against the host
   argmax; then the CLIs ``index_map`` and ``generate_obstacle_map``
   in-process.  Every row of the kernel table gets ``slice9_launches``.
9. Slice 10, the row-sharded build and query (``parallel/sharded.py``).
   After slice 9's build, while the ViT-L/16 net lives:
   ``VLMapBuilder(mesh=)`` on the slice-1 scene (32 frames, batch 8)
   over ``make_mesh(1)`` (the card) and over 4 virtual shards of it
   (``make_mesh(devices=["cuda:0"] * 4)``; 250,001 accumulator rows a
   shard), each held against the single-device batch-8 build: the same
   voxels, weights within rtol 1e-5, features within 2e-2 on the default
   bf16 wire and 1e-5 on the f32 wire; launches (K1-K3 24 a shard
   forward, K4 once a shard step, K5 none); frames/s, host and device ms
   a step, the idle share and K4's ms a shard step (a profiled rebuild);
   over real cards when the machine has two or more; ``all_to_all`` at
   slack 4 equal to the all-gather map bit for bit, at slack 2 a subset
   with each sending shard's drops printed; ``VLMapBuilderMultiFloor
   (mesh=)`` on slice 9's scene over 4 shards against slice 9's build
   (gs padded to a multiple of 4); a warm 4-shard step of each routing
   under ``set_sync_debug_mode("error")``; the payload's bytes and the
   exchange's ms.  After slice 9's robot: ``VLMap.index_map_sharded`` on
   the slice-1 map and ``sharded_score_argmax`` at 1e6 x 512, C = 22,
   over 4 shards, each equal to one K7 launch on every row, and the
   sharded K7's ms against one launch.  K1-K5 and K7 get
   ``slice10_launches``; the numbers print as one JSON line.  In the
   same phase, part A: the LSeg forward of 16 crops equal to that of
   their first 4, to 4 forwards of 4 and to the forward of the 16 in
   reverse order, bit for bit (the DPT's strided conv runs one image at
   a time; ``dpt_batch_check`` prints the probe's row with
   ``lseg.dpt``'s device ms at the batch-8 and the throughput shapes),
   every crop's output independent of the others' at a fixed batch, and
   the 4-shard builds held to the batch-8 build too (bf16 wire 2e-2, f32
   wire 1e-5).
10. Slice 11, recall parity at full width (``avlmaps_torch.tools.
   recall_parity``), last: the reference's LSeg network at ViT-L/16
   width (seeded) in f32 with the host-loop fusion against the port's
   ``VLMapBuilder`` with the same weights in bf16 (K1-K4) and in f32 on
   the tool's synthetic scene at 8 frames of 480^2 (the medium map,
   6,400 points a frame, batch 2); each port map scored by K7 (equal to
   its plain version), the oracle's by numpy; voxel IoU >= 0.97 on both
   rows, f32 top-1 agreement > 0.99; the bf16 row's feature cosine mean
   >= 0.99997 and min >= 0.995, and every bf16 disagreement a near tie
   (the oracle's margin below twice the f32 row's largest |score d|);
   bf16 builds with a planted fault in one block (K3 without its MLP
   term; K2 without its softmax scale) must each fail those bf16 gates;
   K4 on the bf16 build's first step (12,800 rows, S = 32,769) against
   its plain version and bitwise against K5, with its times,
   ``index_add_`` and bound in the ``more_shapes`` line;
   K1-K4 and K7 get ``slice11_launches``; then ``loc_eval`` on the card
   and the CPU (medians within 1e-3 m).
11. Slice 12, the port's tools, last: ``trace_step`` on the batch-8
   sliding step (2 warm, 3 traced; its categories sum to the total,
   K1-K3 24 launches a forward and K4 one a step, the category and
   range table printed); ``profile_step step step_dedup fusion lseg
   vit:fused``; ``ab_fusion_prep`` (each route held to ``index_add_``'s
   accumulator and K4 bitwise K5 before its time); ``port_checkpoints``
   with ``--strict-manifest`` on manifest-shaped files of the 8 release
   artifacts written here, each ``.pt`` loaded onto the card into its
   module, and the bf16 LSeg forward of a 480^2 crop from ``lseg.pt``
   bit for bit the forward from ``load_lseg_checkpoint``; part A's row
   from slice 10 repeated.  Every kernel row gets ``slice12_launches``
   and K1-K5 must each launch.
12. Prints the kernel table as one JSON line, then the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no result line.
It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# map-building shapes (1080x720 frames, 2 crops each, batch of 4 frames)
BATCH = 4
CROPS = 2
T = 901  # 1 + (480/16)^2 tokens per crop
WIDTH = 1024
HEADS = 16
MLP = 4096
POINTS = 7776  # 720 * 1080 / depth_sample_rate 100
FEAT = 512
CAPACITY = 1_000_000
ACCUM_W = FEAT + 128
N_WARM = 4  # frames of the warm-up build (one step)
N_FRAMES = 32  # frames of the measured build (8 steps)
N_PROF = 4  # steps of the profiled build
LAYERS = 24

# the object query's shapes (bench.py's serving query): 1e6 voxels x 512
# f32 on a 1000x1000x30 grid, 21 resident categories + the query, k = 64
N_VOX = 1_000_000
GRID = (1000, 1000, 30)
K_TOP = 64
WORDS = ["chair", "table", "sofa", "bed", "plant", "toilet", "tv", "sink"]
RESIDENT = ["cabinet", "cushion", "counter", "shelving", "stool", "towel",
            "picture", "shower", "bathtub", "fireplace", "gym equipment",
            "seating", "clothes", "door", "window", "curtain", "mirror",
            "lighting", "chest of drawers", "column", "other"]
# the Matterport3D 40-class list (reference
# avlmaps/utils/matterport3d_categories.py); index_object strips the first
# and last entries
MP3D = ["void", "wall", "floor", "chair", "door", "table", "picture",
        "cabinet", "cushion", "window", "sofa", "bed", "curtain",
        "chest_of_drawers", "plant", "sink", "stairs", "ceiling", "toilet",
        "stool", "towel", "mirror", "tv_monitor", "shower", "column",
        "bathtub", "counter", "fireplace", "lighting", "beam", "railing",
        "shelving", "blinds", "gym_equipment", "seating", "board_panel",
        "furniture", "appliances", "clothes", "objects"]
STAGES = ["query.text_encode", "query.score_argmax", "query.scatter_min",
          "query.edt_axis0", "query.edt_axis1", "query.edt_axis2",
          "query.gather_heat", "query.delivery", "query.topk"]

# the throughput build (bench.py's whole-canvas legs): batch 16, 64 frames
THR_BATCH = 16
THR_FRAMES = 64
THR_POINTS = THR_BATCH * POINTS  # 124,416 rows per step, past K4's budget
FRAME_FRAMES = 8  # the frame-transport check: 2 steps of 4

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

REPO = Path(__file__).resolve().parent


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, per_call: int = 0) -> float:
    """Device time of every kernel ``fn`` launches, per call, from
    ``torch.profiler``: the kernels' own time, free of the host's launch
    gaps that bound ``time_ms`` near 0.1 ms for a call that launches two
    or more kernels (a wrapper's pass and GEMM, a library call's ops).
    Each kernel counts at its mean time per launch times its launches per
    call (``per_call`` when given, else the records' count over
    ``iters``): after the build profiles, a later profile in the same
    process can miss some of a kernel's records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count * (per_call or max(
        1, round(e.count / iters))) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _times(r) -> str:
    def dev(key):
        return (f" (device {r[key]:.4f} ms, profiler)" if key in r else "")
    return (f"kernel {r['ms']:.4f} ms{dev('device_ms')}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
            f"{dev('library_device_ms')}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")


def compare(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_abs = float(err.max())
    rel = float((err / want.abs().clamp_min(atol)).max())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={rel:.3e} "
          f"tolerance |d| <= {atol:g} + {rtol:g}*|plain|")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             "tolerance")
    return max_abs


# bf16 outputs: two bf16 ulps of the plain value plus 1e-2 for elements
# near zero (both sides round once from f32 sums taken in different
# orders)
BF_ATOL, BF_RTOL = 1e-2, 2.0 ** -6
# the attention output is an average over ~900 unit-variance values (std
# ~0.05), so its floor is 4e-3, twice the largest error measured at this
# shape: a kernel that lost the last partial key tile (keys 896-900) moves
# typical outputs by more than that.  The kernel's exp2 with scale * log2 e
# folded in moves p by a few f32 ulps, far inside it.
K2_ATOL = 4e-3


def _randn(g, *shape, std=1.0, dtype=None):
    import torch

    return (torch.randn(shape, generator=g, device="cuda") * std).to(
        dtype or torch.bfloat16)


def k2_case(g, nb: int, t: int):
    """K2 (mha_oneshot_2d) on a random (nb*t, 3W) qkv matrix against its
    plain version, timed beside SDPA; returns its kernel-table row and the
    qkv matrix."""
    import torch.nn.functional as F

    from avlmaps_torch.ops import fused_vit as fv

    m = nb * t
    qkv = _randn(g, m, 3 * WIDTH)
    scale = 1.0 / math.sqrt(WIDTH // HEADS)
    k2 = lambda: fv.mha_oneshot_2d(qkv, nb, t, HEADS, scale=scale)  # noqa: E731
    p2 = lambda: fv.mha_oneshot_2d_ref(qkv, nb, t, HEADS, scale=scale)  # noqa: E731

    def lib2():
        q, k, v = qkv.view(nb, t, 3, HEADS, WIDTH // HEADS).permute(
            2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    err = compare(f"K2 mha_oneshot_2d ({nb}, {HEADS}, {t}, 64)", k2(), p2(),
                  K2_ATOL, BF_RTOL)
    b_ms, b_by = bound(4 * nb * t * t * WIDTH, 2 * (m * 3 * WIDTH + m * WIDTH),
                       PEAK_BF16)
    return dict(name="mha_oneshot_2d", fn=fv.mha_oneshot_2d, route="cuda",
                source="avlmaps_torch/csrc/fused_vit.cu",
                replaces="avlmaps_tpu/ops/fused_vit.py:149",
                max_abs_err=err, ms=time_ms(k2), device_ms=device_ms(k2),
                plain_ms=time_ms(p2, 3), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lib2),
                library_device_ms=device_ms(lib2)), qkv


def k1_case(g, m: int, n: int):
    """K1 (ln_matmul) on M random rows at ViT-L width into N columns (3072:
    the qkv projection; 4096: the unfused route's fc) against its plain
    version, timed beside F.layer_norm + F.linear; returns its
    kernel-table row."""
    import torch
    import torch.nn.functional as F

    from avlmaps_torch.ops import fused_vit as fv

    eps = 1e-6
    x = _randn(g, m, WIDTH)
    gam = 1.0 + _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    bet = _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    w = _randn(g, n, WIDTH, std=WIDTH ** -0.5)
    b = _randn(g, n, std=0.1, dtype=torch.float32)
    k1 = lambda: fv.ln_matmul(x, gam, bet, w, b, eps=eps)  # noqa: E731
    p1 = lambda: fv.ln_matmul_ref(x, gam, bet, w, b, eps=eps)  # noqa: E731
    lib1 = lambda: F.linear(F.layer_norm(x, (WIDTH,), gam.to(x.dtype),  # noqa: E731
                                         bet.to(x.dtype), eps), w,
                            b.to(x.dtype))
    err = compare(f"K1 ln_matmul (M={m}, N={n})", k1(), p1(), BF_ATOL,
                  BF_RTOL)
    b_ms, b_by = bound(2 * m * WIDTH * n,
                       2 * (m * WIDTH + n * WIDTH + m * n)
                       + 4 * (2 * WIDTH + n), PEAK_BF16)
    return dict(name="ln_matmul", fn=fv.ln_matmul, route="cuda",
                source="avlmaps_torch/csrc/fused_vit.cu",
                replaces="avlmaps_tpu/ops/fused_vit.py:438",
                max_abs_err=err, ms=time_ms(k1), device_ms=device_ms(k1),
                plain_ms=time_ms(p1, 3), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lib1),
                library_device_ms=device_ms(lib1))


def k3_case(g, m: int):
    """K3 (ln_mlp_residual) on M random rows at ViT-L width against its
    plain version, timed beside LN + two F.linear + GELU; returns its
    kernel-table row."""
    import torch
    import torch.nn.functional as F

    from avlmaps_torch.ops import fused_vit as fv

    eps = 1e-6
    x = _randn(g, m, WIDTH)
    gam = 1.0 + _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    bet = _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    w1 = _randn(g, MLP, WIDTH, std=WIDTH ** -0.5)
    b1 = _randn(g, MLP, std=0.1, dtype=torch.float32)
    w2 = _randn(g, WIDTH, MLP, std=MLP ** -0.5)
    b2 = _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    k3 = lambda: fv.ln_mlp_residual(x, gam, bet, w1, b1, w2, b2, eps=eps)  # noqa: E731
    p3 = lambda: fv.ln_mlp_residual_ref(x, gam, bet, w1, b1, w2, b2,  # noqa: E731
                                        eps=eps)

    def lib3():
        h = F.layer_norm(x, (WIDTH,), gam.to(x.dtype), bet.to(x.dtype), eps)
        h = F.gelu(F.linear(h, w1, b1.to(x.dtype)))
        return x + F.linear(h, w2, b2.to(x.dtype))

    err = compare(f"K3 ln_mlp_residual (M={m})", k3(), p3(), BF_ATOL,
                  BF_RTOL)
    b_ms, b_by = bound(4 * m * WIDTH * MLP,
                       2 * (2 * m * WIDTH + 2 * WIDTH * MLP)
                       + 4 * (3 * WIDTH + MLP), PEAK_BF16)
    return dict(name="ln_mlp_residual", fn=fv.ln_mlp_residual, route="cuda",
                source="avlmaps_torch/csrc/fused_vit.cu",
                replaces="avlmaps_tpu/ops/fused_vit.py:321",
                max_abs_err=err, ms=time_ms(k3), device_ms=device_ms(k3),
                plain_ms=time_ms(p3, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib3),
                library_device_ms=device_ms(lib3))


def kernel_checks():
    """K1-K4 at main-path shapes against their plain versions."""
    import torch
    import torch.nn.functional as F

    from avlmaps_torch.ops import fused_vit as fv
    from avlmaps_torch.ops import segment_scatter as ss

    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    m = BATCH * CROPS * T
    rows = []

    # K1: LN -> qkv
    rows.append(k1_case(g, m, 3 * WIDTH))

    # K2: attention on the fused qkv matrix (plus a masked-key check)
    nb = BATCH * CROPS
    row, qkv = k2_case(g, nb, T)
    scale = 1.0 / math.sqrt(WIDTH // HEADS)
    full = fv.mha_oneshot_2d(qkv, nb, T, HEADS, scale=scale)
    # t_real=832 masks keys 832-900: a whole 64-key tile and a partial one
    masked = fv.mha_oneshot_2d(qkv, nb, T, HEADS, scale=scale, t_real=832)
    compare("K2 mha_oneshot_2d t_real=832", masked,
            fv.mha_oneshot_2d_ref(qkv, nb, T, HEADS, scale=scale,
                                  t_real=832), K2_ATOL, BF_RTOL)
    moved = float((masked.float() - full.float()).abs().max())
    print(f"  K2 mask moves the output by up to {moved:.3e}")
    if moved <= 4 * K2_ATOL:
        raise AssertionError("K2: masking keys 832-900 barely moved the "
                             "output; the check could not see the mask")
    del full, masked, qkv
    rows.append(row)

    # K3: LN -> fc -> GELU -> proj + residual
    rows.append(k3_case(g, m))

    # K4: sorted segment scatter-add into the (1e6+1, 640) accumulator.
    # Rows as fuse_points hands them over: f32 features (the crop average
    # is f32), ~5 points per voxel, invalid points last at the trash slot.
    b = BATCH * POINTS
    slots = torch.sort(torch.randint(0, 6000, (b,), generator=g,
                                     device=dev))[0].to(torch.int32)
    slots[-b // 20:] = CAPACITY
    feats = _randn(g, b, FEAT, dtype=torch.float32)
    w = torch.rand(b, generator=g, device=dev)
    aux = _randn(g, b, ACCUM_W - FEAT, dtype=torch.float32)
    base = torch.zeros(CAPACITY + 1, ACCUM_W, device=dev)
    got = ss.sorted_segment_scatter_add_split(base.clone(), slots, feats, w,
                                              aux)
    want = ss.sorted_segment_scatter_add_split_ref(base.clone(), slots,
                                                   feats, w, aux)
    # f32 sums in the same row order; the kernel fuses w*f into an FMA
    err = compare("K4 sorted_segment_scatter_add_split", got[:CAPACITY],
                  want[:CAPACITY], 1e-4, 1e-5)
    compare("K4 bf16 features",
            ss.sorted_segment_scatter_add_split(
                base.clone(), slots, feats.to(torch.bfloat16), w, aux)[:-1],
            ss.sorted_segment_scatter_add_split_ref(
                base.clone(), slots, feats.to(torch.bfloat16), w, aux)[:-1],
            1e-4, 1e-5)
    del got, want
    acc = base
    update = torch.cat([w[:, None] * feats, aux], dim=1)
    # the bound counts what this data needs: the rows bound for real slots
    # (the trash slot's contents are unspecified) and one read-modify-write
    # of each distinct real slot
    real = slots[slots != CAPACITY]
    n_rows, n_unique = int(real.numel()), int(torch.unique(real).numel())
    k4 = lambda: ss.sorted_segment_scatter_add_split(  # noqa: E731
        acc, slots, feats, w, aux)
    p4 = lambda: ss.sorted_segment_scatter_add_split_ref(acc, slots, feats,  # noqa: E731
                                                         w, aux)
    lib4 = lambda: acc.index_add_(0, slots.long(), update)  # noqa: E731
    b_ms, b_by = bound(2 * n_rows * ACCUM_W,
                       n_rows * (4 * FEAT + 4 + 4 * (ACCUM_W - FEAT) + 4)
                       + n_unique * ACCUM_W * 4 * 2, PEAK_F32)
    rows.append(dict(name="sorted_segment_scatter_add_split",
                     fn=ss.sorted_segment_scatter_add_split, route="cuda",
                     source="avlmaps_torch/csrc/segment_scatter.cu",
                     replaces="avlmaps_tpu/ops/segment_scatter.py:273",
                     max_abs_err=err, ms=time_ms(k4), device_ms=device_ms(k4),
                     plain_ms=time_ms(p4), bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lib4),
                     library_device_ms=device_ms(lib4),
                     runs=run_lengths(slots)))
    for r in rows:
        print(f"  {r['name']}: {_times(r)}")
    return rows


def _uncounted(fn, *args):
    """A check's own launch of a kernel wrapper, kept out of the counts
    of the main path."""
    before = fn.launches
    out = fn(*args)
    fn.launches = before
    return out


def run_lengths(slots, capacity: int = CAPACITY) -> dict:
    """Run-length profile of a sorted batch: the runs of real slots, their
    mean and longest length, the rows in runs longer than 32 and 256, and
    the trash run's rows (slot ``capacity``)."""
    import torch

    vals, counts = torch.unique_consecutive(slots, return_counts=True)
    real = vals != capacity
    c = counts[real]
    return dict(runs=int(c.numel()), mean=round(float(c.float().mean()), 3),
                max=int(c.max()), rows_over_32=int(c[c > 32].sum()),
                rows_over_256=int(c[c > 256].sum()),
                trash=int(counts[~real].sum()))


def _clear_rows(scores, rel: float = 1e-5):
    """Rows whose top-2 score gap exceeds ``rel`` x |top score|."""
    top2 = scores.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > rel * top2[:, 0].abs()


def score_kernel_checks():
    """K7 and K8 at the serving shape against their plain versions, the
    tie cases, and their times."""
    import torch

    from avlmaps_torch.ops import similarity as sim

    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn(N_VOX, FEAT, generator=g, device=dev)
    texts = {c: torch.randn(c, FEAT, generator=g, device=dev)
             for c in (22, 41)}
    rows = []
    for c, t in texts.items():
        # K8 on normalised scores (|s| <= 1): f32 sums of 512 products in
        # another order differ by ~1e-7
        err8 = compare(f"K8 score_features C={c}",
                       sim.score_features(x, t, True, True),
                       sim.score_features_ref(x, t, True, True), 1e-5, 1e-5)
        labels = sim.score_argmax(x, t, normalize_map=True,
                                  normalize_text=True)
        want = sim.score_argmax_ref(x, t, normalize_text=True)
        clear = _clear_rows(sim.score_features_ref(x, t,
                                                   normalize_text=True))
        bad = int((labels != want)[clear].sum())
        print(f"  K7 score_argmax C={c}: {bad} mismatched rows outside the "
              f"near-tie set; {int((~clear).sum())} rows with a top-2 gap "
              f"<= 1e-5 x |top|")
        if bad:
            raise AssertionError(f"K7 disagrees with its plain version on "
                                 f"{bad} rows with a clear maximum")
        th = sim._text_hat(t, True)
        k8 = lambda: sim.score_features(x, t, True, True)  # noqa: E731
        p8 = lambda: sim.score_features_ref(x, t, True, True)  # noqa: E731
        lib8 = lambda: torch.matmul(x, th.T) / torch.clamp(  # noqa: E731
            torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-6)
        k7 = lambda: sim.score_argmax(x, t, True, True)  # noqa: E731
        p7 = lambda: sim.score_argmax_ref(x, t, True, True)  # noqa: E731
        lib7 = lambda: torch.matmul(x, th.T).argmax(1)  # noqa: E731
        b8 = bound(2 * N_VOX * FEAT * c + 2 * N_VOX * FEAT,
                   4 * (N_VOX * FEAT + c * FEAT + N_VOX * c), PEAK_F32)
        b7 = bound(2 * N_VOX * FEAT * c,
                   4 * (N_VOX * FEAT + c * FEAT + N_VOX), PEAK_F32)
        got = [dict(name="score_features", fn=sim.score_features,
                    replaces="avlmaps_tpu/ops/similarity.py:56",
                    max_abs_err=err8, ms=time_ms(k8), device_ms=device_ms(k8),
                    plain_ms=time_ms(p8), bound_ms=b8[0], bound_by=b8[1],
                    library_ms=time_ms(lib8),
                    library_device_ms=device_ms(lib8)),
               dict(name="score_argmax", fn=sim.score_argmax,
                    replaces="avlmaps_tpu/ops/similarity.py:157",
                    max_abs_err=bad, ms=time_ms(k7), device_ms=device_ms(k7),
                    plain_ms=time_ms(p7), bound_ms=b7[0], bound_by=b7[1],
                    library_ms=time_ms(lib7),
                    library_device_ms=device_ms(lib7))]
        for r in got:
            r.update(route="cuda", source="avlmaps_torch/csrc/similarity.cu")
            print(f"  {r['name']} C={c}: {_times(r)}")
        if c == 22:  # the serving shape goes into the kernel table
            rows += got

    # ties: 4096 zero rows tie every category; categories 9 and 30 repeat
    # category 4 (one shared-memory chunk at C=22; at C=41 too)
    xz = x.clone()
    xz[:4096] = 0
    for c, t in texts.items():
        td = t.clone()
        td[9] = td[4]
        if c > 30:
            td[30] = td[4]
        labels = sim.score_argmax(xz, td, normalize_text=True)
        want = sim.score_argmax_ref(xz, td, normalize_text=True)
        clear = _clear_rows(sim.score_features_ref(xz, td,
                                                   normalize_text=True))
        clear[:4096] = False
        if (not bool((labels[:4096] == 0).all())
                or bool(((labels == 9) | (labels == 30)).any())
                or not bool((labels == 4).any())
                or not torch.equal(labels[clear], want[clear])):
            raise AssertionError(f"K7 tie cases fail at C={c}")
        print(f"  K7 ties C={c}: 4096 zero rows -> 0, duplicated categories "
              f"-> the lower index ({int((labels == 4).sum())} rows)")
    del x, xz
    torch.cuda.empty_cache()
    return rows


def write_scene(root: Path, n: int, seed: int, h: int = 720,
                w: int = 1080) -> Path:
    """A synthetic RGB-D walk: colour gradients with noise, a depth ramp
    from 1 m (top) to 4 m (bottom) with a ripple, 5 cm forward and 1 deg of
    yaw per frame (habitat axes, y up)."""
    import cv2

    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h,
                     (xx + yy) * 255 // (h + w)], -1).astype(np.int16)
    poses = []
    for i in range(n):
        rgb = np.clip(base + rng.integers(-20, 20, base.shape), 0,
                      255).astype(np.uint8)
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"), rgb[..., ::-1])
        depth = (1.0 + 3.0 * yy / h
                 + 0.3 * np.sin(xx / 40.0 + 0.2 * i)).astype(np.float32)
        np.save(root / "depth" / f"{i:06d}.npy", depth)
        th = np.deg2rad(float(i))
        poses.append([0.0, 0.0, -0.05 * i, 0.0, np.sin(th / 2), 0.0,
                      np.cos(th / 2)])
    np.savetxt(root / "poses.txt", np.asarray(poses))
    return root


class PositionGate:
    """After every build, every exported slot position lies inside the
    grid (0 <= row, col < gs, 0 <= h < vh) and is whole.  A slot whose
    position columns summed two voxels' positions -- two runs of equal
    slots merged into one -- reads past the grid, as a column of 1035 once
    did on the 1000-wide grid.

    Installed over the ``fuse_points`` and ``_save`` of both builders
    (``VLMapBuilder`` and ``VLMapBuilderMultiFloor``): each
    fusion step records on the card, with no host sync, how many used
    slots lie outside and the first of them; each save checks those
    records and the final state before the export, and fails with the
    step, the slot and its neighbours' positions."""

    def __init__(self):
        from avlmaps_torch.map import vlmap_builder as vb
        from avlmaps_torch.map import vlmap_builder_multi_floor as mf

        self.steps, self.record = [], True
        self.n_builds = self.n_steps = 0
        for module, cls in ((vb, vb.VLMapBuilder),
                            (mf, mf.VLMapBuilderMultiFloor)):
            module.fuse_points = self._checked_fuse(module.fuse_points)
            cls._save = self._checked_save(cls._save)

    def _checked_fuse(self, fuse):
        def fuse_checked(state, *args, **kw):
            out = fuse(state, *args, **kw)
            if self.record:
                self.steps.append(self.outside(out, kw["gs"], kw["vh"]))
            return out

        return fuse_checked

    def _checked_save(self, save):
        def save_checked(builder, state, gs, vh, mapped):
            self.check(state, gs, vh)
            return save(builder, state, gs, vh, mapped)

        return save_checked

    @staticmethod
    def outside(state, gs: int, vh: int):
        """(count, first) of the used slots whose position is not a whole
        grid cell, as device scalars."""
        import torch

        d, cap = state.feat_dim, state.accum.shape[0] - 1
        pos = state.accum[:cap, d + 4:d + 7]
        bad = ((pos < 0).any(1) | (pos[:, 0] >= gs) | (pos[:, 1] >= gs)
               | (pos[:, 2] >= vh) | (pos != torch.round(pos)).any(1))
        bad &= torch.arange(cap, device=pos.device) < state.n_slots
        return bad.sum(), torch.argmax(bad.to(torch.uint8))

    def check(self, state, gs: int, vh: int) -> None:
        steps, self.steps = self.steps, []
        self.n_builds += 1
        self.n_steps += len(steps)
        n_final, first = (int(t) for t in self.outside(state, gs, vh))
        counts = [int(n) for n, _ in steps]
        if n_final == 0 and not any(counts):
            return
        step = next((i for i, n in enumerate(counts) if n), None)
        slot = first if step is None else int(steps[step][1])
        d, lo = state.feat_dim, max(slot - 2, 0)
        near = state.accum[lo:slot + 3, d + 4:d + 7].cpu().tolist()
        raise AssertionError(
            f"position gate: {n_final} slots outside the {gs}x{gs}x{vh} "
            f"grid after the build; the first seen at fusion step {step} of "
            f"{len(counts)} (None: after the last), slot {slot}; positions "
            f"of slots {lo}..{lo + len(near) - 1}: {near}")

    @contextlib.contextmanager
    def paused(self):
        """No per-step records (a profiled build); the save still checks
        the final state."""
        self.record = False
        try:
            yield
        finally:
            self.record = True


GATE = None  # the PositionGate main() installs
PATH_MS = {}  # the last profiled build's port kernels: ms a launch, by name


def path_ms(kernel: str) -> float:
    """ms a launch of ``kernel`` (every instantiation) in the last
    profiled build."""
    found = [v for k, v in PATH_MS.items() if kernel in k]
    if len(found) != 1:
        raise AssertionError(f"{kernel}: {len(found)} instantiations in "
                             "the profiled build, expected 1")
    return found[0]


def profile_build(b, steps: int, attribute: bool = False) -> float:
    """Device time by kernel over a short build (torch.profiler).  Returns
    the device ms per step: every kernel and copy of the build except the
    export's device->host copies, over the steps (the rule of
    ``avlmaps_torch.tools.trace_step``).  With ``attribute``, also prints
    the torch ops by the device time of the kernels they launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avlmaps_torch.tools import trace_step as tsp

    with GATE.paused(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        b.create_mobile_base_map(save_every=0, progress=False)
        torch.cuda.synchronize()
    kernels = tsp.device_averages(prof)
    step_ms = tsp.build_device_ms(prof, steps)
    print(f"  profiled {steps}-step build: device busy {step_ms:.3f} ms per "
          f"step (export copies excluded), {len(kernels)} kernel names; "
          "top by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    PATH_MS.clear()
    for e in kernels:
        name = next((k for k in tsp.PORT_KERNELS if k in e.key), None)
        if name is not None:
            print(f"    port kernel {name}: {e.count}x, "
                  f"{e.self_device_time_total / 1e3 / e.count:.4f} ms each "
                  f"({e.key[:60]})")
            PATH_MS[e.key] = e.self_device_time_total / 1e3 / e.count
    if attribute:
        tsp.attribute_ops(prof, steps)
    return step_ms


def time_producer(scene: Path, mc, n_frames: int) -> float:
    """The host producer alone, ms per batch: PNG and npy decode, canvas
    resize, pixel sampling and the pinned copy to the card, with no step
    consuming the batches."""
    from avlmaps_torch.map.vlmap_builder import sample_pixels
    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.pipeline.loader import PrefetchLoader
    from avlmaps_torch.pipeline.transport import make_canvas_transform

    h, w = 720, 1080
    height, width, _, _, _ = plan_windows(h, w)
    rng = np.random.default_rng(0)
    n_pts = mc.point_budget(h, w)
    transform = make_canvas_transform(
        lambda nb: sample_pixels(rng, h, w, mc.depth_sample_rate, n_pts, nb),
        (height, width))
    return producer_ms(PrefetchLoader(
        sorted((scene / "rgb").glob("*.png")),
        sorted((scene / "depth").glob("*.npy")),
        [np.eye(4)] * n_frames, batch_size=BATCH, normalize=False,
        transform=transform, device="cuda"))


def producer_ms(loader) -> float:
    """A loader's ms per batch with no step consuming the batches."""
    import torch

    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_batches


def slice_run(rows, tmp: Path):
    """The map build at full width, with launch counts and output checks;
    returns the scene directory, whose ``vlmap/vlmaps.h5df`` holds the map,
    the network, and the fusion inputs of the warm-up build's step."""
    import torch

    from avlmaps_torch.config import load_config
    from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                                   build_base_transform)
    from avlmaps_torch.map import vlmap_builder as vb
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder
    from avlmaps_torch.map.voxel_map import SparseVoxelMap
    from avlmaps_torch.models.lseg import (LOGIT_SCALE, LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           init_params)

    cfg = LSegConfig.vitl16(torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    net.eval().requires_grad_(False)

    mc = load_config().map_config  # gs 1000, cs 0.05, vh 30, cap 1e6
    assert (mc.gs, mc.vh, mc.capacity) == (1000, 30, CAPACITY)
    pi = mc.pose_info
    base2cam = build_base2cam_tf(pi.base2cam_rot, pi.camera_height)
    base_tf = build_base_transform(pi.base_forward_axis, pi.base_left_axis,
                                   pi.base_up_axis)

    def apply(x):
        return net(x, upsample=False)

    def builder(scene: Path) -> VLMapBuilder:
        return VLMapBuilder(
            scene, mc, scene / "poses.txt",
            sorted((scene / "rgb").glob("*.png")),
            sorted((scene / "depth").glob("*.npy")), base2cam, base_tf,
            lseg_apply=apply, feat_dim=FEAT, batch_size=BATCH, seed=0,
            half_res_apply=True, device="cuda")

    t0 = time.perf_counter()
    warm = write_scene(tmp / "warm", N_WARM, seed=1)
    scene = write_scene(tmp / "scene", N_FRAMES, seed=0)
    print(f"  scenes written in {time.perf_counter() - t0:.1f} s")
    # the warm-up build (one step) hands K4's real-step check its inputs
    captured, fuse = [], vb.fuse_points

    def capture(state, *args, **kw):
        if not captured:
            captured.extend(a.clone() for a in args)
        return fuse(state, *args, **kw)

    vb.fuse_points = capture
    try:
        builder(warm).create_mobile_base_map(save_every=0, progress=False)
    finally:
        vb.fuse_points = fuse

    for r in rows:
        r["fn"].launches = 0
    b = builder(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = b.create_mobile_base_map(save_every=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in rows:
        r["launches"] = r["fn"].launches
    steps = math.ceil(N_FRAMES / BATCH)
    reloaded = SparseVoxelMap.load(b.map_save_path)
    producer_ms = time_producer(scene, mc, N_FRAMES)
    prof_scene = write_scene(tmp / "prof", N_PROF * BATCH, seed=2)
    device_ms = profile_build(builder(prof_scene), N_PROF)
    rows[3]["path"] = path_ms("segment_scatter_kernel")

    stats = b.build_stats
    print(f"  frames={stats['frames']} voxels={stats['voxels']} "
          f"points_dropped={stats['points_dropped']} steps={steps}")
    host_ms = 1e3 * BATCH / stats["fps"]
    print(f"  steady-state fps={stats['fps']:.2f} (builder RateMeter) "
          f"ms/step={host_ms:.1f}; whole build {wall:.2f} s incl. export "
          f"and HDF5 save; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  per step: host loop {host_ms:.1f} ms (measured build), device "
          f"busy {device_ms:.1f} ms (profiled build of another scene); idle "
          f"share {1 - device_ms / host_ms:.3f} pairs the two; "
          f"host producer alone {producer_ms:.1f} ms per batch of {BATCH}")
    launches = {r["name"]: r["launches"] for r in rows}
    print(f"  launches: {launches}")
    want = {"ln_matmul": LAYERS * steps, "mha_oneshot_2d": LAYERS * steps,
            "ln_mlp_residual": LAYERS * steps,
            "sorted_segment_scatter_add_split": steps}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    n = m.grid_feat.shape[0]
    if stats["frames"] != N_FRAMES or n == 0 or n != stats["voxels"]:
        raise AssertionError(f"build stats {stats}, {n} voxels saved")
    if m.grid_feat.shape != (n, FEAT) or not np.isfinite(m.grid_feat).all():
        raise AssertionError("grid_feat is not finite (N, 512)")
    norms = np.linalg.norm(m.grid_feat, axis=1)
    if norms.max() > LOGIT_SCALE * 1.01 or not (m.weight > 0).all():
        raise AssertionError("fused features exceed the logit-scale norm or "
                             "a voxel has no weight")
    lo, hi = m.grid_pos.min(0), m.grid_pos.max(0)
    if lo.min() < 0 or hi[0] >= mc.gs or hi[1] >= mc.gs or hi[2] >= mc.vh:
        raise AssertionError(f"grid_pos out of the grid: {lo} {hi}")
    for key in ("grid_feat", "grid_pos", "weight"):
        if not np.array_equal(getattr(m, key), getattr(reloaded, key)):
            raise AssertionError(f"HDF5 reload changed {key}")
    print(f"  HDF5 reload equal; |feat| in [{norms.min():.3f}, "
          f"{norms.max():.3f}] (logit scale {LOGIT_SCALE:.3f})")

    # one crop through the card (kernels) and the CPU (plain versions)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    crop = torch.randn(1, 480, 480, 3, generator=g, device="cuda")
    with torch.no_grad():
        on_card = net(crop, upsample=False).float().cpu()
        cpu_net = copy.deepcopy(net).to("cpu")
        on_cpu = cpu_net(crop.cpu(), upsample=False).float()
    cos = torch.nn.functional.cosine_similarity(on_card, on_cpu, dim=-1)
    print(f"  one crop, card vs CPU plain path: per-pixel cosine min "
          f"{float(cos.min()):.6f} mean {float(cos.mean()):.6f}")
    # 24 bf16 blocks whose sums run in another order on each side
    if float(cos.min()) < 0.999:
        raise AssertionError("card features disagree with the CPU path")
    del cpu_net
    return scene, net, captured


def vit_kernel_checks():
    """K6 and K2 on (B, H, T, D) tensors at the ViT-L shapes against their
    plain versions, with times."""
    import torch
    import torch.nn.functional as F

    from avlmaps_torch.ops import fused_vit as fv

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    m = BATCH * CROPS * T
    rows = []
    # K6: GELU(fc output) -> proj, the unfused MLP's second product
    x = _randn(g, m, MLP)
    w = _randn(g, WIDTH, MLP, std=MLP ** -0.5)
    b = _randn(g, WIDTH, std=0.1, dtype=torch.float32)
    k6 = lambda: fv.gelu_matmul(x, w, b)  # noqa: E731
    p6 = lambda: fv.gelu_matmul_ref(x, w, b)  # noqa: E731
    lib6 = lambda: F.linear(F.gelu(x), w, b.to(x.dtype))  # noqa: E731
    err = compare("K6 gelu_matmul", k6(), p6(), BF_ATOL, BF_RTOL)
    b_ms, b_by = bound(2 * m * MLP * WIDTH,
                       2 * (m * MLP + WIDTH * MLP + m * WIDTH) + 4 * WIDTH,
                       PEAK_BF16)
    rows.append(dict(name="gelu_matmul", fn=fv.gelu_matmul, route="cuda",
                     source="avlmaps_torch/csrc/fused_vit.cu",
                     replaces="avlmaps_tpu/ops/fused_vit.py:459",
                     max_abs_err=err, ms=time_ms(k6), device_ms=device_ms(k6),
                     plain_ms=time_ms(p6, 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib6),
                     library_device_ms=device_ms(lib6)))
    del x

    # K2 on (B, H, T, D): the flash/splash layout, 8 crops x 16 heads
    nb, hd = BATCH * CROPS, WIDTH // HEADS
    q, k, v = (_randn(g, nb, HEADS, T, hd) for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    k2 = lambda: fv.mha_bhtd(q, k, v, scale=scale)  # noqa: E731
    p2 = lambda: fv.mha_bhtd_ref(q, k, v, scale=scale)  # noqa: E731
    lib2 = lambda: F.scaled_dot_product_attention(q, k, v,  # noqa: E731
                                                  scale=scale)
    err = compare("K2 mha_bhtd (B, H, T, D)", k2(), p2(), K2_ATOL, BF_RTOL)
    qkv = _randn(g, nb, T, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    compare("K2 mha_bhtd on strided head-split views",
            fv.mha_bhtd(qkv[0], qkv[1], qkv[2], scale=scale, t_real=832),
            fv.mha_bhtd_ref(qkv[0], qkv[1], qkv[2], scale=scale,
                            t_real=832), K2_ATOL, BF_RTOL)
    b_ms, b_by = bound(4 * nb * HEADS * T * T * hd,
                       2 * 4 * nb * HEADS * T * hd, PEAK_BF16)
    rows.append(dict(name="mha_bhtd", fn=fv.mha_bhtd, route="cuda",
                     source="avlmaps_torch/csrc/fused_vit.cu",
                     replaces="avlmaps_tpu/models/lseg/vit.py:81",
                     max_abs_err=err, ms=time_ms(k2), device_ms=device_ms(k2),
                     plain_ms=time_ms(p2, 3), bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lib2),
                     library_device_ms=device_ms(lib2)))
    for r in rows:
        print(f"  {r['name']}: {_times(r)}")
    return rows


def _map_setup():
    from avlmaps_torch.config import load_config
    from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                                   build_base_transform)

    mc = load_config().map_config
    pi = mc.pose_info
    return mc, (build_base2cam_tf(pi.base2cam_rot, pi.camera_height),
                build_base_transform(pi.base_forward_axis, pi.base_left_axis,
                                     pi.base_up_axis))


def _frames(scene: Path):
    return (sorted((scene / "rgb").glob("*.png")),
            sorted((scene / "depth").glob("*.npy")))


def _builder(net, mc, tfs, scene: Path, batch: int, **kw):
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    saved = scene / "vlmap" / "vlmaps.h5df"
    if saved.exists():  # a fresh build, not a resume
        saved.unlink()
    return VLMapBuilder(scene, mc, scene / "poses.txt", *_frames(scene),
                        *tfs, lseg_apply=lambda x: net(x, upsample=False),
                        feat_dim=FEAT, batch_size=batch, seed=0,
                        half_res_apply=True, device="cuda", **kw)


def _zero(rows):
    for r in rows:
        r["fn"].launches = 0


def _counts(rows):
    return {r["name"]: r["fn"].launches for r in rows}


def _measured_build(name, make, rows, steps, producer_loader,
                    attribute=False):
    """One timed build (after a warm one), its launch counts, a profile of
    a second build and the producer alone; prints the step numbers."""
    import torch

    _zero(rows)
    b = make()
    # the steps end where the final save starts: the builder's loop runs
    # ahead of the card, so its own rate meter times the enqueue
    save, loop_end = b._save, []

    def timed_save(*args):
        torch.cuda.synchronize()
        loop_end.append(time.perf_counter())
        return save(*args)

    b._save = timed_save
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = b.create_mobile_base_map(save_every=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(rows)
    stats = b.build_stats
    device_ms = profile_build(make(), steps, attribute)
    producer = producer_ms(producer_loader())
    step_ms = (loop_end[-1] - t0) * 1e3 / steps
    enqueue_ms = 1e3 * THR_BATCH / stats["fps"]
    print(f"  {name}: frames={stats['frames']} voxels={stats['voxels']} "
          f"steps={steps}; {1e3 * THR_BATCH / step_ms:.2f} frames/s, "
          f"{step_ms:.1f} ms per step (host clock to the last step's end, "
          f"set-up included); device busy {device_ms:.1f} ms per step "
          f"(profiled rebuild), idle share {1 - device_ms / step_ms:.3f}; "
          f"the loop enqueues a step in {enqueue_ms:.1f} ms (RateMeter); "
          f"producer alone {producer:.1f} ms per batch of {THR_BATCH}; "
          f"whole build {wall:.2f} s with export and save")
    print(f"  {name} launches: {counts}")
    if stats["frames"] != THR_FRAMES or m.grid_feat.shape[0] == 0 \
            or not np.isfinite(m.grid_feat).all():
        raise AssertionError(f"{name}: build stats {stats}")
    return m, counts


def throughput_run(net, tmp: Path, k5_row, path_rows):
    """The throughput build: a packed 64-frame scene, device sampling,
    whole-canvas eval, batch 16 (K5 once a step, K4 never), then the same
    frames through the canvas transport.  Returns the fusion inputs of one
    real batch-16 step (captured during the warm-up build)."""
    import torch

    from avlmaps_torch.map import vlmap_builder as vb
    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.ops.voxel_fusion import init_fusion_state
    from avlmaps_torch.pipeline.packed import (PackedLoader, PackedScene,
                                               pack_scene)

    mc, tfs = _map_setup()
    mc.lseg_eval = "whole"
    canvas_hw = plan_windows(720, 1080)[:2]
    t0 = time.perf_counter()
    warm = write_scene(tmp / "thr_warm", THR_BATCH, seed=3)
    scene = write_scene(tmp / "thr", THR_FRAMES, seed=4)
    for sc in (warm, scene):
        pack_scene(*_frames(sc), sc / "scene.avpack", canvas_hw=canvas_hw)
    print(f"  64 + 16 frames written and packed (canvas {canvas_hw}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # warm-up build of one step, capturing its fusion inputs
    captured = []
    fuse = vb.fuse_points

    def capture(state, *args, **kw):
        if not captured:
            captured.extend(a.clone() for a in args)
        return fuse(state, *args, **kw)

    # ... and the token count the ViT sees on the padded canvas
    seen = []
    hook = net.backbone.blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
    vb.fuse_points = capture
    try:
        _builder(net, mc, tfs, warm, THR_BATCH,
                 sampling="device").create_mobile_base_map(
            save_every=0, progress=False)
    finally:
        vb.fuse_points = fuse
        hook.remove()
    thr_t = seen[0][1]
    print(f"  the ViT sees (batch, tokens, width) = {seen[0]} on the padded "
          f"canvas: M = {seen[0][0] * thr_t} token rows")
    if seen[0] != (THR_BATCH, thr_t, WIDTH):
        raise AssertionError(f"unexpected ViT input {seen[0]}")
    if captured[0].shape != (THR_POINTS,):
        raise AssertionError(f"captured batch {captured[0].shape}")

    # a warm device-sampled step makes no host synchronisation
    step = vb.make_frame_step_device_sampled(
        lambda x: net(x, upsample=False), gs=mc.gs, cs=mc.cs, vh=mc.vh,
        calib_mat=mc.calib_matrix(), image_hw=(720, 1080),
        max_pts=mc.point_budget(720, 1080), seed=0, device="cuda")
    batch = list(PackedLoader(PackedScene(warm / "scene.avpack"),
                              [np.eye(4)] * THR_BATCH, batch_size=THR_BATCH,
                              raw_canvas=True, device="cuda"))[0]
    state = init_fusion_state(mc.gs, mc.vh, FEAT, mc.capacity,
                              device="cuda")
    fids = torch.from_numpy(batch.frame_ids).cuda()
    valid = torch.ones(THR_BATCH, dtype=torch.bool, device="cuda")
    with torch.no_grad():
        step(state, batch.canvas, batch.depth_mm, batch.pose_tf, fids, valid)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(state, batch.canvas, batch.depth_mm, batch.pose_tf, fids,
                 valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("  pass: a warm device-sampled batch-16 step ran under "
          "set_sync_debug_mode('error')")
    GATE.check(state, mc.gs, mc.vh)
    del state, batch, step

    steps = THR_FRAMES // THR_BATCH
    rows = path_rows + [k5_row]
    pk = PackedScene(scene / "scene.avpack")
    poses = [np.eye(4)] * THR_FRAMES
    _, counts = _measured_build(
        "device-sampled packed build (whole, batch 16)",
        lambda: _builder(net, mc, tfs, scene, THR_BATCH, sampling="device"),
        rows, steps,
        lambda: PackedLoader(pk, poses, batch_size=THR_BATCH,
                             raw_canvas=True, device="cuda"),
        attribute=True)
    k5_row["path"] = path_ms("segment_scatter_kernel")
    k5_row["launches"] = counts["sorted_segment_scatter_add"]
    want = {"ln_matmul": LAYERS * steps, "mha_oneshot_2d": LAYERS * steps,
            "ln_mlp_residual": LAYERS * steps,
            "sorted_segment_scatter_add_split": 0,
            "sorted_segment_scatter_add": steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    rng = np.random.default_rng(0)
    n_pts = mc.point_budget(720, 1080)
    _, counts = _measured_build(
        "canvas transport on the same frames (host sampling, whole, "
        "batch 16)",
        lambda: _builder(net, mc, tfs, scene, THR_BATCH),
        rows, steps,
        lambda: PackedLoader(pk, poses, batch_size=THR_BATCH,
                             sampler=lambda nb: vb.sample_pixels(
                                 rng, 720, 1080, mc.depth_sample_rate,
                                 n_pts, nb), device="cuda"))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return captured, thr_t, want


def throughput_shape_checks(thr_t: int, launches: dict):
    """K1, K3 and K2 at the throughput build's shapes (batch 16 whole
    canvas: M = 16 * thr_t rows, attention on (16, 16, thr_t, 64)) against
    their plain versions, with times, bounds and library times; the
    launches are the throughput build's.  Then K1 at N = 4096, the fc of
    the unfused-MLP route, at M = 7208 (its launches are K6's route run)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    m = THR_BATCH * thr_t
    out = [k1_case(g, m, 3 * WIDTH), k3_case(g, m),
           k2_case(g, THR_BATCH, thr_t)[0]]
    for r in out:
        r["launches"] = launches[r["name"]]
        r["shape"] = (f"({THR_BATCH}, {HEADS}, {thr_t}, 64)"
                      if r["name"] == "mha_oneshot_2d" else f"M={m}")
        print(f"  {r['name']} {r['shape']}: {_times(r)}, {r['launches']} "
              "launches in the throughput build")
    fc = k1_case(g, BATCH * CROPS * T, MLP)
    fc.update(shape=f"M={BATCH * CROPS * T}, N={MLP}", launches=None)
    print(f"  ln_matmul {fc['shape']} (the unfused route's fc): "
          f"{_times(fc)}")
    torch.cuda.empty_cache()
    return out + [fc]


class _AllocatingLib:
    """The kernel library with one launch function wrapped: just before it
    forwards, it allocates 16 ``torch.zeros`` of the batch's row count on
    the launch's stream -- what the loader's producer thread may do between
    the wrapper's checks and the launch.  A kernel that read anything but
    its arguments (a scratch tensor the wrapper let go of) could find its
    block zeroed ahead of the launch (tests/test_torch_cuda.py holds the
    same)."""

    def __init__(self, lib, name: str, n_rows: int):
        self._lib, self._name, self._n = lib, name, n_rows
        self.held = []

    def __getattr__(self, attr):
        import torch

        fn = getattr(self._lib, attr)
        if attr != self._name:
            return fn

        def launch(*args):
            for _ in range(16):
                self.held.append(torch.zeros(self._n, dtype=torch.uint8,
                                             device="cuda"))
            return fn(*args)

        return launch


def _sorted_step(captured, gs: int = None, vh: int = None,
                 capacity: int = CAPACITY, n_rows: int = None):
    """A captured fusion step sorted into a fresh state, as fuse_points
    hands it to K4/K5: the slice-1 grid by default, or a row shard's
    (``n_rows`` rows of a ``gs`` grid, ``capacity`` slots)."""
    from avlmaps_torch.ops import voxel_fusion as vf

    if gs is None:
        mc, _ = _map_setup()
        gs, vh = mc.gs, mc.vh
    state = vf.init_fusion_state(gs, vh, FEAT, capacity, device="cuda",
                                 n_rows=n_rows)
    return vf.sort_batch(state, *captured, gs=gs, vh=vh, n_rows=n_rows)


def k4_real_check(captured, k4_row):
    """K4 on a real sorted batch-4 sliding step (the warm-up build's)
    against its plain version and bitwise against K5 on the same batch,
    with its device time beside index_add_'s and its bound."""
    import torch

    from avlmaps_torch.ops import segment_scatter as ss

    sb = _sorted_step(captured)
    update = torch.cat([sb.w[:, None] * sb.feats.float(), sb.aux], dim=1)
    base = torch.zeros(CAPACITY + 1, ACCUM_W, device="cuda")
    k4 = ss.sorted_segment_scatter_add_split
    got = _uncounted(k4, base.clone(), sb.slots, sb.feats, sb.w, sb.aux)
    want = ss.sorted_segment_scatter_add_split_ref(base.clone(), sb.slots,
                                                   sb.feats, sb.w, sb.aux)
    err = compare(f"K4 on a real batch-{BATCH} step ({sb.slots.numel()} "
                  "rows)", got[:CAPACITY], want[:CAPACITY], 1e-4, 1e-5)
    del want
    k5 = _uncounted(ss.sorted_segment_scatter_add, base.clone(), sb.slots,
                    update)
    same = torch.equal(got[:CAPACITY], k5[:CAPACITY])
    print(f"  {'pass' if same else 'FAIL'}: K4 == K5 bitwise on rows "
          f"[0, {CAPACITY}) of the real step")
    if not same:
        raise AssertionError("K4 and K5 disagree on the real step")
    del got, k5
    real = sb.slots[sb.slots != CAPACITY]
    n_rows, n_unique = int(real.numel()), int(torch.unique(real).numel())
    esz = sb.feats.element_size()
    b_ms, b_by = bound(2 * n_rows * ACCUM_W,
                       n_rows * (esz * FEAT + 4 + 4 * (ACCUM_W - FEAT) + 4)
                       + n_unique * ACCUM_W * 8, PEAK_F32)
    acc, idx = base, sb.slots.long()
    before = k4.launches
    step = dict(rows=int(sb.slots.numel()), feats=str(sb.feats.dtype)[6:],
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms(lambda: k4(acc, sb.slots, sb.feats, sb.w,
                                               sb.aux)),
                library_device_ms=device_ms(
                    lambda: acc.index_add_(0, idx, update)),
                runs=run_lengths(sb.slots))
    k4.launches = before
    k4_row["real_step"] = step
    print(f"  K4 on the real step: device {step['device_ms']:.4f} ms "
          f"(profiler), index_add_ {step['library_device_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); runs {step['runs']}")
    del acc, base, update, idx
    torch.cuda.empty_cache()


def k5_check(captured, k5_row):
    """K5 on a real sorted batch-16 step against its plain version,
    bitwise against K4's kernel on the same batch, and bitwise against
    itself with allocations made between its wrapper and its launch."""
    import torch

    from avlmaps_torch.ops import segment_scatter as ss

    sb = _sorted_step(captured)
    update = torch.cat([sb.w[:, None] * sb.feats.float(), sb.aux], dim=1)
    base = torch.zeros(CAPACITY + 1, ACCUM_W, device="cuda")
    got = _uncounted(ss.sorted_segment_scatter_add, base.clone(), sb.slots,
                     update)
    want = ss.sorted_segment_scatter_add_ref(base.clone(), sb.slots, update)
    err = compare("K5 sorted_segment_scatter_add (124,416 rows)",
                  got[:CAPACITY], want[:CAPACITY], 1e-4, 1e-5)
    del want
    k4 = ss.sorted_segment_scatter_add_split
    before = k4.launches  # a check's launch, not the main path's
    split = ss.split_kernel(base.clone(), sb.slots, sb.feats, sb.w, sb.aux)
    k4.launches = before
    same = torch.equal(got[:CAPACITY], split[:CAPACITY])
    print(f"  {'pass' if same else 'FAIL'}: K5 == K4 bitwise on rows "
          f"[0, {CAPACITY}) of the same batch")
    if not same:
        raise AssertionError("K5 and K4 disagree on one batch")
    del split
    # the kernel reads only its arguments: allocations of the batch's size
    # between the wrapper and the launch, as the loader's producer thread
    # may make, change no bit
    lib = _AllocatingLib(ss._lib(), "avl_segment_scatter_add", THR_POINTS)
    load = ss._lib
    ss._lib = lambda: lib
    try:
        stood = _uncounted(ss.sorted_segment_scatter_add, base.clone(),
                           sb.slots, update)
    finally:
        ss._lib = load
    same = torch.equal(stood[:CAPACITY], got[:CAPACITY]) and bool(lib.held)
    print(f"  {'pass' if same else 'FAIL'}: K5 with {len(lib.held)} "
          "allocations of the batch's size just before its launch == K5 "
          "bitwise")
    if not same:
        raise AssertionError("K5 changed with allocations made between its "
                             "wrapper and its launch")
    del got, stood
    real = sb.slots[sb.slots != CAPACITY]
    n_rows, n_unique = int(real.numel()), int(torch.unique(real).numel())
    print(f"  real batch: {THR_POINTS} rows, {n_rows} bound for {n_unique} "
          "voxels, the rest in the trash run")
    acc = base
    b_ms, b_by = bound(n_rows * ACCUM_W,
                       n_rows * (4 * ACCUM_W + 4) + n_unique * ACCUM_W * 8,
                       PEAK_F32)
    before = ss.sorted_segment_scatter_add.launches
    k5 = lambda: ss.sorted_segment_scatter_add(acc, sb.slots,  # noqa: E731
                                               update)
    p5 = lambda: ss.sorted_segment_scatter_add_ref(acc, sb.slots,  # noqa: E731
                                                   update)
    lib5 = lambda: acc.index_add_(0, sb.slots.long(), update)  # noqa: E731
    k5_row.update(max_abs_err=err, ms=time_ms(k5), device_ms=device_ms(k5),
                  plain_ms=time_ms(p5), bound_ms=b_ms, bound_by=b_by,
                  library_ms=time_ms(lib5),
                  library_device_ms=device_ms(lib5),
                  runs=run_lengths(sb.slots))
    ss.sorted_segment_scatter_add.launches = before
    print(f"  sorted_segment_scatter_add: {_times(k5_row)}; path "
          f"{k5_row['path']:.4f} ms a launch in the build's profile; runs "
          f"{k5_row['runs']}")
    del acc, base, update
    torch.cuda.empty_cache()


def frame_transport_run(net, tmp: Path, k4_row):
    """The frame transport (sliding, batch 4) against the canvas transport
    on the same frames and the same host draws, with the tolerances of
    tests/test_canvas_transport.py for a resized canvas.  Both read one
    pack, so both see the same uint16-mm depth (the canvas transport ships
    depth in millimetres; the npy frames hold metres)."""
    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.pipeline.packed import pack_scene

    mc, tfs = _map_setup()
    mc.lseg_eval = "sliding"
    scene = write_scene(tmp / "frame", FRAME_FRAMES, seed=5)
    pack_scene(*_frames(scene), scene / "scene.avpack",
               canvas_hw=plan_windows(720, 1080)[:2])
    maps = {}
    for transport in ("frame", "canvas"):
        k4_row["fn"].launches = 0
        b = _builder(net, mc, tfs, scene, BATCH, transport=transport)
        maps[transport] = b.create_mobile_base_map(save_every=0,
                                                   progress=False)
        print(f"  {transport} transport: {b.build_stats['fps']:.2f} "
              f"frames/s over {FRAME_FRAMES // BATCH} steps, K4 launches "
              f"{k4_row['fn'].launches}")
        if k4_row["fn"].launches != FRAME_FRAMES // BATCH:
            raise AssertionError("K4 did not run once a step")
    f, c = maps["frame"], maps["canvas"]
    denom = np.maximum(np.abs(f.grid_feat), 1e-3)
    med = float(np.median(np.abs(c.grid_feat - f.grid_feat) / denom))
    checks = {
        "grid_pos equal": np.array_equal(f.grid_pos, c.grid_pos),
        "occupied_ids equal": np.array_equal(f.occupied_ids,
                                             c.occupied_ids),
        "weight within rtol 1e-6": np.allclose(f.weight, c.weight,
                                               rtol=1e-6, atol=0),
        "grid_rgb within 1": int(np.abs(f.grid_rgb.astype(int)
                                        - c.grid_rgb).max()) <= 1,
        "median relative feature difference < 0.05": med < 0.05,
    }
    print(f"  {f.grid_feat.shape[0]} voxels; median relative feature "
          f"difference {med:.4f} (the canvas transport's uint8 canvas)")
    for name, ok in checks.items():
        print(f"  {'pass' if ok else 'FAIL'}: frame vs canvas transport: "
              f"{name}")
    if not all(checks.values()):
        raise AssertionError("frame transport disagrees with the canvas "
                             "transport")


def _tap_cosine(a, b) -> float:
    import torch

    return min(float(torch.nn.functional.cosine_similarity(
        x.float(), y.float(), dim=-1).min()) for x, y in zip(a, b))


def vit_routes_run(net, k6_row, k2s_row):
    """8-crop ViT-L taps through the unfused-MLP route (K1 + K6) and the
    flash route (K2 on (B, H, T, D)) against the default fused route; the
    launch counts of those two runs are K6's and K2-strided's."""
    import torch

    from avlmaps_torch.ops import fused_vit as fv

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    crops = torch.randn(BATCH * CROPS, 480, 480, 3, generator=g,
                        device="cuda")
    vit = net.backbone
    with torch.no_grad():
        ref = vit(crops)
        _zero([k6_row])
        fv.MLP_FUSE = False
        try:
            unfused = vit(crops)
        finally:
            fv.MLP_FUSE = True
        k6_row["launches"] = k6_row["fn"].launches
        _zero([k2s_row])
        for blk in vit.blocks:
            blk.attn_impl = "flash"
        try:
            flash = vit(crops)
        finally:
            for blk in vit.blocks:
                blk.attn_impl = "fused"
        k2s_row["launches"] = k2s_row["fn"].launches
    cos_u, cos_f = _tap_cosine(unfused, ref), _tap_cosine(flash, ref)
    print(f"  taps, per-token cosine min against the fused route: "
          f"MLP_FUSE=False {cos_u:.6f} (K6 launches {k6_row['launches']}), "
          f"attn_impl='flash' {cos_f:.6f} (mha_bhtd launches "
          f"{k2s_row['launches']})")
    n = len(vit.blocks)
    if k6_row["launches"] != n or k2s_row["launches"] != n:
        raise AssertionError("a route did not launch its kernel per block")
    if min(cos_u, cos_f) < 0.999:
        raise AssertionError("a ViT route disagrees with the fused route")


def f32_lseg_check():
    """A medium f32 LSeg on the card (unfused plain ops, full f32) against
    the CPU, within the 5e-3 the CPU tests hold the port to flax."""
    import torch

    from avlmaps_torch.models.lseg import LSegConfig, LSegNet, init_params

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for matmul or cuDNN")
    cfg = LSegConfig.medium()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cpu = LSegNet(cfg, device="cpu")
    cpu.load_state_dict(_cpu_state(net))
    x = torch.randn(2, 192, 192, 3, generator=gen, device="cuda")
    with torch.no_grad():
        got = net(x).cpu()
        want = cpu(x.cpu())
    err = float((got - want).abs().max())
    print(f"  medium f32 LSeg, card vs CPU: max |diff| {err:.3e} "
          "(tolerance 5e-3 + 5e-3 * |CPU|)")
    torch.testing.assert_close(got, want, atol=5e-3, rtol=5e-3)


def clip_check():
    """The full-width ViT-B/32 CLIP (seeded weights) on the card against
    the port's CPU path; returns the card's encoder."""
    import torch

    from avlmaps_torch.models.clip import MULTIPLE_TEMPLATES, ClipEncoder

    t0 = time.perf_counter()
    enc = ClipEncoder("ViT-B/32", seed=0, device="cuda")
    cfg = enc.cfg
    print(f"  ViT-B/32 text tower: {cfg.text_layers} layers, width "
          f"{cfg.text_width}, {cfg.text_heads} heads, context "
          f"{cfg.context_length}; set up in {time.perf_counter() - t0:.1f} s")
    cpu = ClipEncoder("ViT-B/32", device="cpu", params=_cpu_state(enc.model))
    names = ["chair"] + RESIDENT
    worst = 1.0
    for what, fn in (("plain prompts", lambda e: e.get_text_feats(names)),
                     ("64-template ensembles",
                      lambda e: e.get_text_feats_multiple_templates(
                          names))):
        a, b = fn(enc), fn(cpu)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                * np.linalg.norm(b, axis=1))
        print(f"  {what}: {len(a)} texts, card vs CPU cosine min "
              f"{cos.min():.7f}")
        worst = min(worst, float(cos.min()))
    # both sides compute in f32; only the summation order differs
    if worst < 0.9999:
        raise AssertionError("CLIP text features disagree with the CPU path")
    tokens = enc.device_tokens([t.format("chair")
                                for t in MULTIPLE_TEMPLATES])
    print(f"  template-ensemble encode of one word (64 prompts, ids cut to "
          f"{tokens.shape[1]} of {cfg.context_length} tokens): "
          f"{time_ms(lambda: enc.encode_templates(tokens)):.3f} ms")
    return enc


def _device_ms(e):
    t = getattr(e, "device_time_total", None)
    return (e.cuda_time_total if t is None else t) / 1e3


def profile_queries(query, args, n: int):
    """Prints the device ms per query: in total (every kernel and copy)
    and by stage (the ``query.*`` ranges the port marks with
    ``record_function``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for w in WORDS[:n]:
            query(w, *args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    total = sum(e.self_device_time_total for e in events
                if e.device_type == gpu and not e.key.startswith("query."))
    total = total / 1e3 / n
    stages = {e.key: _device_ms(e) / n for e in events
              if e.device_type == cpu and e.key in STAGES}
    # K7 is launched through ctypes, not by a torch op, so the profiler
    # does not attribute it to its range: count it by kernel name
    k7 = sum(e.self_device_time_total for e in events
             if e.device_type == gpu and "score_kernel" in e.key)
    stages["query.score_argmax"] = (stages.get("query.score_argmax", 0.0)
                                    + k7 / 1e3 / n)
    print(f"  profiled {n} queries: device busy {total:.3f} ms per query; "
          "by stage:")
    for name in STAGES:
        print(f"    {name[6:]:<12} {stages.get(name, float('nan')):8.3f} ms")
    if total <= 0 or len(stages) != len(STAGES):
        raise AssertionError("the profiler saw no device time per stage")
    top = sorted((e for e in events if e.device_type == gpu
                  and not e.key.startswith("query.")),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms/query "
              f"{e.count // n:4d}x  {e.key[:80]}")


def serving_run(enc):
    """The serving query at production scale: rate, latency, parity with
    the host heat, no host sync before the fetch, K7 once per query."""
    import torch

    from avlmaps_torch.ops import delivery as dlv
    from avlmaps_torch.ops import similarity as sim

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for matmul or cuDNN")
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    feats = torch.randn(N_VOX, FEAT, generator=g, device="cuda")
    pos = torch.stack([torch.randint(0, s, (N_VOX,), generator=g,
                                     device="cuda") for s in GRID],
                      1).to(torch.int32)
    other = enc.get_text_feats_multiple_templates(RESIDENT, as_device=True)
    query = dlv.make_text_object_query(enc, GRID, cell_size=0.05,
                                       decay_rate=0.01, k=K_TOP,
                                       with_topk=True, device="cuda")
    args = (feats, pos, other)
    keys = ("goal_pos", "topk_vals", "topk_pos")

    def epoch() -> float:
        t0 = time.perf_counter()
        pending = [dlv.copy_to_host_async(*(o[k] for k in keys))
                   for o in (query(w, *args) for w in WORDS)]
        for _, event in pending:
            event.synchronize()
        return len(WORDS) / (time.perf_counter() - t0)

    epoch()  # warm-up
    rates = sorted(epoch() for _ in range(3))
    lat = []
    for w in WORDS[:4]:
        t0 = time.perf_counter()
        dlv.fetch_np(query(w, *args)["goal_pos"])
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"  serving: {rates[1]:.2f} queries/s median over 3 epochs of "
          f"{len(WORDS)} (min {rates[0]:.2f}, max {rates[-1]:.2f}); "
          f"synchronous latency {sorted(lat)[len(lat) // 2]:.2f} ms median "
          f"of {len(lat)} (min {min(lat):.2f})")

    # parity with the host heat, on a query that also returns the u8 head
    before = sim.score_argmax.launches
    out = dlv.make_text_object_query(enc, GRID, cell_size=0.05,
                                     decay_rate=0.01, k=K_TOP, with_u8=True,
                                     device="cuda")("chair", *args)
    if sim.score_argmax.launches != before + 1:
        raise AssertionError("the serving query did not launch K7 once")
    heat, u8, goal, tv, tp = dlv.fetch_np(out["heat"], out["heat_u8"],
                                          *(out[k] for k in keys))
    pos_h = pos.cpu().numpy()
    text = torch.cat([enc.get_text_feats_multiple_templates(
        ["chair"], as_device=True), other])
    mask = (_uncounted(sim.score_argmax, feats, text, True, True)
            == 0).cpu().numpy()
    order = np.argsort(-heat, kind="stable")[:K_TOP]
    checks = {
        "goal == grid_pos[argmax(host heat)]":
            np.array_equal(goal, pos_h[int(np.argmax(heat))]),
        "heat in [0, 1]": bool(heat.min() >= 0 and heat.max() <= 1),
        "heat == 1 on every target": bool((heat[mask] == 1).all()),
        "top-k values == stable top-k of host heat":
            np.array_equal(tv, heat[order]),
        "top-k positions == stable top-k of host heat":
            np.array_equal(tp, pos_h[order]),
        "heat_u8 == round(heat * 255)":
            np.array_equal(u8, np.round(heat * 255).astype(np.uint8)),
    }
    print(f"  'chair': {int(mask.sum())} target voxels of {N_VOX}, "
          f"{int((heat > 0).sum())} with heat > 0, goal {goal.tolist()}")
    for name, ok in checks.items():
        print(f"  {'pass' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("serving query parity failed")

    # no host synchronisation from the query's start to its fetch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = query("sofa", *args)
        host, event = dlv.copy_to_host_async(*(out[k] for k in keys))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    event.synchronize()
    print("  pass: a warm query ran under set_sync_debug_mode('error') up "
          "to its fetch")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was switched on during the query")

    profile_queries(query, args, 4)
    del feats, pos, out
    torch.cuda.empty_cache()


def object_query_run(enc, scene: Path):
    """The object query through AVLMap on the map slice 1 built."""
    import torch

    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.avlmap import AVLMap
    from avlmaps_torch.ops import similarity as sim
    from avlmaps_torch.ops.delivery import fetch_np
    from avlmaps_torch.ops.heatmap import heatmap_from_mask_3d

    cfg = load_config()
    avl = AVLMap(cfg, clip_encoder=enc, device="cuda")
    vm = avl.vlmap
    if not vm.load_map(scene):
        raise AssertionError("the slice-1 map did not load")
    n = vm.grid_feat.shape[0]
    feats = torch.from_numpy(vm.grid_feat).cuda()

    before = sim.score_features.launches
    scores = vm.init_categories(MP3D[1:-1])
    if sim.score_features.launches != before + 1:
        raise AssertionError("init_categories did not launch K8 once")
    names = MP3D[1:-1] + ["other"]
    text = enc.get_text_feats_multiple_templates(names, as_device=True)
    ref = sim.score_features_ref(feats, text)
    err = float((torch.from_numpy(scores).cuda() - ref).abs().max())
    clear = _clear_rows(ref)
    by_cat = vm.index_map("chair")
    want = (ref.argmax(1) == names.index("chair")).cpu().numpy()
    ok_cat = np.array_equal(by_cat[clear.cpu().numpy()],
                            want[clear.cpu().numpy()])
    fused = vm.index_map("chair", with_init_cat=False)
    text2 = enc.get_text_feats_multiple_templates(["chair", "other"],
                                                  as_device=True)
    ref2 = sim.score_features_ref(feats, text2)
    clear2 = _clear_rows(ref2).cpu().numpy()
    ok_fused = np.array_equal(fused[clear2],
                              (ref2.argmax(1) == 0).cpu().numpy()[clear2])
    print(f"  map: {n} voxels; init_categories: {len(names)} categories "
          f"(K8 once), max |score - plain| {err:.2e}; index_map('chair'): "
          f"{int(by_cat.sum())} voxels by the preloaded categories, "
          f"{int(fused.sum())} by K7 against 'other'")

    f32 = avl.index_object("chair", decay_rate=0.01)
    u8 = avl.index_object("chair", decay_rate=0.01, delivery="u8")
    dev = avl.index_object("chair", decay_rate=0.01, delivery="device")
    vals, tpos = avl.index_object("chair", decay_rate=0.01, delivery="topk")
    goal = avl.index_object("chair", decay_rate=0.01, delivery="goal")
    order = np.argsort(-f32, kind="stable")[:K_TOP]
    mp = avl.index_object("chair", init_categories=MP3D, decay_rate=0.01)

    # the serving query against the staged path: its labels (K7 with the
    # text normalised, as the JAX serving program scores) -> the dense
    # heat.  index_map scores the raw template means (the reference's
    # get_lseg_score), so where the two texts' norms differ the two masks
    # may differ too; that count is printed, not held
    out = vm.make_serving_query(k=8)("chair")
    heat_s, goal_s = fetch_np(out["heat"], out["goal_pos"])
    text_s = torch.cat([enc.get_text_feats_multiple_templates(
        [w], as_device=True) for w in ("chair", "other")])
    labels_s = _uncounted(sim.score_argmax, feats, text_s, True,
                          True).cpu().numpy()
    ref_s = sim.score_features_ref(feats, text_s, normalize_text=True)
    clear_s = _clear_rows(ref_s).cpu().numpy()
    same_s = np.array_equal(labels_s[clear_s],
                            ref_s.argmax(1).cpu().numpy()[clear_s])
    staged = heatmap_from_mask_3d(
        vm.grid_pos, labels_s == 0, cell_size=vm.cs, decay_rate=0.01,
        method="dense", lattice_unit=1.0, grid_shape=vm.occupied_ids.shape,
        device="cuda")
    print(f"  serving mask vs index_map's (raw text norms): "
          f"{int(((labels_s == 0) != fused).sum())} of {n} voxels differ; "
          f"{int((~clear_s).sum())} near ties")
    vm.customize_obstacle_map(["chair", "table", "sofa"], ["table"])
    contours, _, _ = vm.get_pos("chair")
    checks = {
        "init_categories scores == plain (atol 1e-4)": err <= 1e-4,
        "index_map with categories == plain argmax on clear rows": ok_cat,
        "index_map by K7 == plain argmax on clear rows": ok_fused,
        "index_object f32 finite in [0, 1], 1 on targets":
            bool(np.isfinite(f32).all() and f32.min() >= 0
                 and f32.max() <= 1 and (f32[fused] == 1).all()),
        "u8 within 0.5/255 of f32":
            float(np.abs(u8 - f32).max()) <= 0.5 / 255 + 1e-7,
        "device == f32": np.array_equal(dev.cpu().numpy(), f32),
        "topk == stable top-k of f32": bool(
            np.array_equal(vals, f32[order])
            and np.array_equal(tpos, vm.grid_pos[order])),
        "goal == grid_pos[argmax(f32)]":
            np.array_equal(goal, vm.grid_pos[int(np.argmax(f32))]),
        "index_object with init_categories in [0, 1]":
            bool(mp.shape == (n,) and mp.min() >= 0 and mp.max() <= 1),
        "make_serving_query == dense heat of its labels (atol 1e-5)": bool(
            np.abs(heat_s - staged).max() <= 1e-5
            and np.array_equal(goal_s,
                               vm.grid_pos[int(np.argmax(staged))])),
        "serving labels == plain argmax on clear rows": same_s,
        "customize_obstacle_map and get_pos ran":
            vm.obstacles_new_cropped is not None
            and isinstance(contours, list),
    }
    print(f"  index_object('chair'): {int((f32 == 1).sum())} voxels at 1, "
          f"goal {np.asarray(goal).tolist()}; get_pos: {len(contours)} "
          "islands")
    for name, ok in checks.items():
        print(f"  {'pass' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("object query on the built map failed")


# slice 7's sound scene: 20 sequences (considered_seq_num_per_scene) of
# 12 s at 44.1 kHz, each with 3 bursts of 1.5-2.6 s at least 1.2 s apart
SOUND_SEQS = 20
SOUND_SR = 44100
SOUND_SECONDS = 12
SOUND_FPS = 25
AUDIO_BATCH = 10


def write_sound_scene(scene: Path, seed: int = 0) -> int:
    """``<scene>/audio_video/<seq>/audio.wav`` + ``poses.txt`` for every
    sequence: noisy tones between exact silences (the sound map splits at
    1 s of silence), and a 25 fps habitat pose walk within 3 m of the
    scene's start; returns the bursts written."""
    from avlmaps_torch.utils.audio import write_wav

    rng = np.random.default_rng(seed)
    n = SOUND_SECONDS * SOUND_SR
    bursts = 0
    for q in range(SOUND_SEQS):
        seq = scene / "audio_video" / f"{q:06d}"
        seq.mkdir(parents=True)
        audio = np.zeros(n, np.float32)
        t0 = 0.5
        for _ in range(3):
            d = rng.uniform(1.5, 2.6)
            i0, i1 = int(t0 * SOUND_SR), int((t0 + d) * SOUND_SR)
            t = np.arange(i1 - i0) / SOUND_SR
            audio[i0:i1] = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 4000)
                                         * t)
                            + 0.1 * rng.normal(size=t.size))
            bursts += 1
            t0 += d + rng.uniform(1.2, 1.8)
        write_wav(seq / "audio.wav", np.clip(audio, -1, 1), SOUND_SR)
        steps = SOUND_SECONDS * SOUND_FPS
        xz = np.cumsum(rng.normal(0, 0.04, (steps, 2)), 0)
        xz = np.clip(xz + rng.uniform(-1.5, 1.5, 2), -3.0, 3.0)
        yaw = np.cumsum(rng.normal(0, 0.02, steps))
        np.savetxt(seq / "poses.txt", np.stack(
            [xz[:, 0], np.zeros(steps), xz[:, 1], np.zeros(steps),
             np.sin(yaw / 2), np.zeros(steps), np.cos(yaw / 2)], 1))
    return bursts


def _tf32_probe(module):
    """Records (cuDNN TF32, cuBLAS TF32) each time ``module`` runs."""
    import torch

    seen = []
    handle = module.register_forward_pre_hook(lambda *_: seen.append((
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32)))
    return seen, handle


def _cpu_state(module):
    return {k: v.cpu() for k, v in module.state_dict().items()}


def _tf32_on(name: str, modules, fn, checks: dict):
    """Runs ``fn`` with TF32 switched on for cuDNN and cuBLAS, as a user
    of the port may have it, and requires both flags off inside every
    forward of ``modules``."""
    import torch

    seen, hooks = [], []
    for m in modules:
        s, h = _tf32_probe(m)
        seen.append(s)
        hooks.append(h)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = fn()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for h in hooks:
            h.remove()
    flags = [f for s in seen for f in s]
    print(f"  TF32 (cuDNN, cuBLAS) inside the {name} forward: {set(flags)}")
    checks[f"TF32 off inside the {name} forward, on outside"] = bool(
        flags) and not any(a or b for a, b in flags)
    return out


def _cosine_rows(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _card_vs_cpu(name: str, got, want) -> dict:
    """The embedding rule of slice 7: cosine >= 0.9999 and max |d| <= 1e-3
    after L2 normalisation, row by row."""
    cos = _cosine_rows(got, want)
    g = got / np.linalg.norm(got, axis=1, keepdims=True)
    w = want / np.linalg.norm(want, axis=1, keepdims=True)
    err = float(np.abs(g - w).max())
    print(f"  {name}: {len(got)} rows, card vs CPU cosine min "
          f"{cos.min():.7f}, max |d| {err:.2e} (L2-normalised)")
    return {f"{name}: cosine >= 0.9999 and max |d| <= 1e-3":
            bool(cos.min() >= 0.9999 and err <= 1e-3)}


def profile_call(fn):
    """(device ms, kernel launches, copies) of one call of ``fn`` from
    ``torch.profiler``; the port's ``record_function`` ranges, which the
    profiler lists among the device events, are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avlmaps_torch.tools import trace_step

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gpu = trace_step.device_averages(prof)
    copies = [e for e in gpu if e.key.startswith(("Memcpy", "Memset"))]
    ms = sum(e.self_device_time_total for e in gpu) / 1e3
    return (ms, sum(e.count for e in gpu) - sum(e.count for e in copies),
            sum(e.count for e in copies))


def sound_area_run(enc, scene: Path, rows):
    """Slice 7: the area and sound maps on the scene slice 1 built, loaded
    through ``AVLMap.load_map``, and the area, sound and multimodal
    queries at gs = 1000.  ``enc`` is slice 2's ViT-B/32 encoder (the
    VLMap's); ``rows`` are K7's and K8's kernel-table rows, whose counts
    this phase reads for itself."""
    import torch

    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.area_map import AreaMap
    from avlmaps_torch.map.avlmap import AVLMap
    from avlmaps_torch.map.sound_map import SoundMap
    from avlmaps_torch.models.audioclip import AudioClipEncoder
    from avlmaps_torch.models.clip import ClipEncoder
    from avlmaps_torch.ops import delivery as dlv
    from avlmaps_torch.utils import audio as au

    t_phase = time.perf_counter()
    cfg = load_config()
    cc = cfg.sound_data_collect_params
    assert cc.considered_seq_num_per_scene == SOUND_SEQS
    bursts = write_sound_scene(scene)
    checks = {}

    # AudioCLIP at full width, one batch of 10 of the sound map's own clips
    t0 = time.perf_counter()
    aenc = AudioClipEncoder(seed=0, device="cuda")
    acfg = aenc.cfg.audio
    acpu = AudioClipEncoder(aenc.cfg, device="cpu",
                            params=_cpu_state(aenc.model))
    print(f"  AudioCLIP: ESResNeXt {acfg.layers} x{acfg.groups}x"
          f"{acfg.width_per_group}, n_fft {acfg.n_fft}, hop "
          f"{acfg.hop_length}, win {acfg.win_length}, embed "
          f"{aenc.cfg.embed_dim}; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    clips = []
    for seq in sorted((scene / "audio_video").iterdir())[:4]:
        audio, sr = au.read_wav(seq / "audio.wav", cc.sample_rate)
        _, tracks = au.segment_audio_with_silence(
            audio, cc.silence_duration_s, cc.silence_threshold, sr)
        clips += [au.get_five_second_context(t * 32768.0, 2.5, sr)
                  for t in tracks]
    batch = np.stack([aenc.prepare_audio(c) for c in clips[:AUDIO_BATCH]])
    spec = aenc.model.audio.spectrogram(torch.from_numpy(batch[:1]).cuda())
    print(f"  one batch: {tuple(batch.shape)} samples -> spectrogram "
          f"{(AUDIO_BATCH,) + tuple(spec.shape[1:])}")
    # TF32 on outside, as a user of the port has it by default: the
    # towers must switch it off for themselves
    card = _tf32_on("audio", (aenc.model.audio.conv1, aenc.model.audio.fc),
                    lambda: aenc.encode_audio_device(batch).cpu().numpy(),
                    checks)
    checks.update(_card_vs_cpu("audio embeddings, 10 full clips", card,
                               acpu.encode_audio_device(batch).numpy()))
    del acpu
    xb = torch.from_numpy(batch).cuda()
    ms = time_ms(lambda: aenc.model.encode_audio(xb), iters=5)
    dev = device_ms(lambda: aenc.model.encode_audio(xb), iters=3)
    print(f"  audio tower, batch {AUDIO_BATCH}: {ms:.2f} ms a batch (CUDA "
          f"events), {AUDIO_BATCH * 1e3 / ms:.1f} clips/s; device "
          f"{dev:.2f} ms a batch (profiler)")

    # the area map's CLIP ViT-L/14 at 224
    t0 = time.perf_counter()
    venc = ClipEncoder("ViT-L/14", seed=0, device="cuda")
    vcpu = ClipEncoder("ViT-L/14", device="cpu",
                       params=_cpu_state(venc.model))
    print(f"  CLIP ViT-L/14 at {venc.cfg.image_size}: set up in "
          f"{time.perf_counter() - t0:.1f} s")
    from avlmaps_torch.pipeline.loader import load_rgb

    frames = [load_rgb(p) for p in sorted((scene / "rgb").glob("*.png"))[:2]]
    checks.update(_card_vs_cpu("ViT-L/14 image features, 2 frames",
                               venc.get_imgs_feats_batch(frames),
                               vcpu.get_imgs_feats_batch(frames)))
    del vcpu

    # the two maps, then AVLMap.load_map on the scene
    area = AreaMap(str(scene), clip_encoder=venc, device="cuda")
    t0 = time.perf_counter()
    area.create_map(scene)
    n_frames = len(area.rgb_paths)
    t_area = time.perf_counter() - t0
    sound = SoundMap(str(scene), cfg.sound_config, cc,
                     audioclip_encoder=aenc, device="cuda")
    t0 = time.perf_counter()
    db = sound.create_sound_map(str(scene))
    t_sound = time.perf_counter() - t0
    poses = sum(len(e["locations"]) for e in db.values())
    print(f"  area map: {n_frames} frames in {t_area:.2f} s, "
          f"{n_frames / t_area:.1f} frames/s; sound map: {len(db)} events "
          f"found of {bursts} bursts in {SOUND_SEQS} sequences, "
          f"{poses} poses, in {t_sound:.2f} s")
    checks["sound map: one event a burst"] = len(db) == bursts

    for r in rows:
        r["fn"].launches = 0
    avl = AVLMap(cfg, clip_encoder=enc, area_clip_encoder=venc,
                 audioclip_encoder=aenc, device="cuda")
    avl.load_map(scene)
    vm = avl.vlmap
    n, gs = vm.grid_pos.shape[0], vm.occupied_ids.shape[0]
    cpu_avl = copy.copy(avl)
    cpu_avl.vlmap = copy.copy(vm)
    cpu_avl.vlmap.device = torch.device("cpu")
    for name, query, word in (("area", "index_area_2d", "kitchen"),
                              ("sound", "index_sound_2d",
                               "glass_breaking")):
        fn = getattr(avl, query)
        f32 = fn(word)
        heat = fn(word, delivery="device")
        u8 = fn(word, delivery="u8")
        on_cpu = getattr(cpu_avl, query)(word)
        err = float(np.abs(f32 - on_cpu).max())
        host_u8 = np.round(np.clip(f32, 0, 1) * np.float32(255)) \
            / np.float32(255)
        ms, launches, copies = profile_call(
            lambda: fn(word, delivery="device"))
        print(f"  {query}('{word}') at {gs}x{gs}: max |card - CPU| "
              f"{err:.2e}; one call: {ms:.3f} ms of device work, "
              f"{launches} kernel launches, {copies} copies (profiler)")
        checks[f"{query}: (gs, gs) on the card, == CPU (atol 1e-5)"] = bool(
            isinstance(heat, torch.Tensor) and heat.is_cuda
            and f32.shape == (gs, gs) and err <= 1e-5
            and f32.max() == 1.0)
        checks[f"{query}: u8 == host quantisation"] = np.array_equal(
            u8, host_u8)
        lifted = getattr(avl, query[:-3])(word)
        checks[f"{query[:-3]}: (N,) finite"] = bool(
            lifted.shape == (n,) and np.isfinite(lifted).all())

    # the multimodal goal: object (K8 with the categories, K7 without) x
    # area x sound, fused on the card.  The synthetic walk sees its voxels
    # 1-4 m ahead, beyond the area heat's default reach (10 cells at decay
    # 0.1 a cell) and at the edge of the sound heat's (100 cells), so both
    # decay at 0.005 a cell here: the product must be positive somewhere,
    # or the goal check would hold trivially
    area3 = avl.index_area("kitchen", decay_rate=0.005)
    sound3 = avl.index_sound("glass_breaking", decay_rate=0.005)
    # the seeded weights label no voxel 'chair' among the 39 categories
    # (slice 2 prints the count), so the K8 query names the category that
    # labels the most voxels; K7 against 'other' finds chairs
    avl.index_object("chair", init_categories=MP3D, delivery="device")
    cats = MP3D[1:-1]
    labels = np.argmax(vm.scores_mat, axis=1)
    top = cats[int(np.bincount(labels, minlength=len(cats) + 1)[
        :len(cats)].argmax())]
    obj8 = avl.index_object(top, init_categories=MP3D, decay_rate=0.01,
                            delivery="device")
    obj7 = avl.index_object("chair", decay_rate=0.01, delivery="device")
    print(f"  K8 query: '{top}', {int((labels == cats.index(top)).sum())} "
          f"voxels; K7 query: 'chair', {int((obj7 == 1).sum())} voxels")
    for label, obj in (("K8", obj8), ("K7", obj7)):
        pos, val = dlv.fetch_np(*dlv.fused_goal_pick([obj, area3, sound3],
                                                     vm.grid_pos))
        fused = obj.cpu().numpy() * area3 * sound3
        print(f"  object ({label}) x area x sound: goal "
              f"{np.asarray(pos).tolist()}, heat {float(val):.4f}")
        checks[f"object ({label}) x area x sound goal == host argmax, "
               "heat > 0"] = bool(
            np.array_equal(pos, vm.grid_pos[int(np.argmax(fused))])
            and abs(float(val) - float(fused.max())) <= 1e-6
            and float(val) > 0)
    counts = {r["name"]: r["fn"].launches for r in rows}
    for r in rows:
        r["slice7_launches"] = r["fn"].launches
    print(f"  slice 7 launches: {counts}")
    checks["K7 and K8 launched in this phase"] = min(counts.values()) >= 1
    print(f"  slice 7 phase: {time.perf_counter() - t_phase:.1f} s wall")
    for name, ok in checks.items():
        print(f"  {'pass' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("slice 7: the sound and area path failed")


# the refinement recipe of tests/test_visual_map.py: a 240x320 textured
# canvas at 2 m, the query camera moved 25 cm along x; NetVLAD's card-vs-CPU
# size; Wav2CLIP's batch of the sound map's clips
REFINE_H, REFINE_W = 240, 320
REFINE_DEPTH, REFINE_TX = 2.0, 0.25
W2C_CLIPS = 10


def textured_canvas(rng, h: int, w: int) -> np.ndarray:
    """400 filled squares of 4-9 px in random colours on a dark canvas,
    drawn with numpy (the recipe's cv2.rectangle fills the same pixels)."""
    canvas = np.full((h, w, 3), 30, np.uint8)
    for _ in range(400):
        x, y = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 8))
        sz = int(rng.integers(3, 9))
        canvas[y:y + sz + 1, x:x + sz + 1] = rng.integers(40, 255, 3)
    return canvas


def superpoint_check(frames, checks: dict):
    """Full-width SuperPoint on one 720x1080 frame, card against CPU;
    returns the card's extractor, the CPU's and the gray frames."""
    from avlmaps_torch.map.visual_map import VisualMap
    from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                                 SuperPointExtractor)

    cfg = SuperPointConfig()
    sp = SuperPointExtractor(cfg, seed=0, device="cuda")
    sp_cpu = SuperPointExtractor(cfg, params=_cpu_state(sp.model),
                                 device="cpu")
    grays = np.stack([VisualMap._to_gray(f) for f in frames[:2]])
    card = _tf32_on("SuperPoint", (sp.model.conv1a, sp.model.convDb),
                    lambda: sp.extract(grays[:1]), checks)
    cpu = sp_cpu.extract(grays[:1])
    pos = {}
    for side, out in (("card", card), ("cpu", cpu)):
        kp = out["keypoints"][0][out["valid"][0]]
        pos[side] = {(float(x), float(y)): i for i, (x, y) in enumerate(kp)}
    shared = sorted(set(pos["card"]) & set(pos["cpu"]))
    share = len(shared) / max(len(pos["card"]), len(pos["cpu"]))
    ic = [pos["card"][k] for k in shared]
    ip = [pos["cpu"][k] for k in shared]
    s_err = float(np.abs(card["scores"][0][ic] - cpu["scores"][0][ip]).max())
    d_err = float(np.abs(card["descriptors"][0][ic]
                         - cpu["descriptors"][0][ip]).max())
    ms = time_ms(lambda: sp.extract_device(grays[:1]), iters=5)
    dev_ms, launches, _ = profile_call(lambda: sp.extract_device(grays[:1]))
    print(f"  SuperPoint {cfg.channels}, det/desc {cfg.det_ch}, D "
          f"{cfg.desc_dim}, {grays.shape[1]}x{grays.shape[2]}: "
          f"{len(pos['card'])} valid keypoints "
          f"of {cfg.max_keypoints}; card vs CPU: {len(shared)} shared "
          f"(share {share:.4f}), at shared keypoints max |score d| "
          f"{s_err:.2e}, max |descriptor d| {d_err:.2e}; {ms:.2f} ms an "
          f"image (CUDA events, upload to keypoints), {dev_ms:.3f} ms of "
          f"device work in {launches} kernel launches (profiler)")
    checks["SuperPoint: keypoint sets card vs CPU share >= 0.99"] = \
        share >= 0.99
    checks["SuperPoint: shared scores within 1e-6, descriptors within "
           "1e-4"] = s_err <= 1e-6 and d_err <= 1e-4
    return sp, sp_cpu, grays, ms


def superglue_check(sp, grays, checks: dict):
    """Full-width SuperGlue with 100 Sinkhorn iterations on two frames'
    1024 + 1024 keypoints, card against CPU."""
    import torch

    from avlmaps_torch.models.superglue import (SuperGlueConfig,
                                                SuperGlueMatcher,
                                                match_from_assignment)

    cfg = SuperGlueConfig(sinkhorn_iters=100)
    sg = SuperGlueMatcher(cfg, seed=0, device="cuda")
    sg_cpu = SuperGlueMatcher(cfg, params=_cpu_state(sg.model), device="cpu")
    f0, f1 = sp.extract(grays[:1]), sp.extract(grays[1:2])
    hw = grays.shape[1:]
    z = _tf32_on("SuperGlue", (sg.model.kenc.enc0, sg.model.final_proj),
                 lambda: sg.assignment(f0, f1, hw).cpu(), checks)
    z_cpu = sg_cpu.assignment(f0, f1, hw)
    err = float((z - z_cpu).abs().max())
    v0 = torch.from_numpy(f0["valid"])
    v1 = torch.from_numpy(f1["valid"])
    agree = {}
    for th in (cfg.match_threshold, 0.0):
        a = match_from_assignment(z, v0, v1, th)[0]
        b = match_from_assignment(z_cpu, v0, v1, th)[0]
        agree[th] = (float((a == b).float().mean()), int((b >= 0).sum()))
    dev0 = {k: torch.from_numpy(v).cuda() for k, v in f0.items()}
    dev1 = {k: torch.from_numpy(v).cuda() for k, v in f1.items()}
    ms = time_ms(lambda: sg.match(dev0, dev1, hw), iters=5)
    dev_ms, launches, copies = profile_call(lambda: sg.match(dev0, dev1, hw))
    print(f"  SuperGlue {cfg.gnn_layers} layer pairs, {cfg.heads} heads, D "
          f"{cfg.desc_dim}, {cfg.sinkhorn_iters} Sinkhorn iterations, "
          f"{z.shape[1] - 1} + {z.shape[2] - 1} keypoints: Z card vs CPU "
          f"max |d| {err:.2e}; decisions agree "
          + ", ".join(f"{s:.4f} at threshold {t} ({n} CPU matches)"
                      for t, (s, n) in agree.items())
          + f"; {ms:.2f} ms a match (CUDA events), {dev_ms:.3f} ms of "
          f"device work in {launches} kernel launches and {copies} copies "
          "(profiler)")
    checks["SuperGlue: Z card vs CPU within 1e-3"] = err <= 1e-3
    checks["SuperGlue: decisions agree on >= 0.99 of the rows"] = min(
        s for s, _ in agree.values()) >= 0.99
    return ms, launches


def netvlad_check(frames, checks: dict):
    """Full-width NetVLAD (VGG16 + VLAD + 32,768 -> 4,096 whitening):
    card against CPU at 240x320, then frames/s over the scene's frames at
    720x1080."""
    import torch

    from avlmaps_torch.models.netvlad import NetVLADConfig, NetVLADEncoder

    cfg = NetVLADConfig()
    nv = NetVLADEncoder(cfg, seed=0, device="cuda")
    nv_cpu = NetVLADEncoder(cfg, params=_cpu_state(nv.model), device="cpu")
    small = [np.ascontiguousarray(f[:REFINE_H, :REFINE_W]) for f in frames[:2]]
    card = _tf32_on("NetVLAD", (nv.model.backbone.conv_0, nv.model.whiten),
                    lambda: nv.get_imgs_feats_batch(small, 2), checks)
    checks.update(_card_vs_cpu("NetVLAD at 240x320, 2 frames", card,
                               nv_cpu.get_imgs_feats_batch(small, 2)))
    del nv_cpu
    nv.get_imgs_feats_batch(frames[:8], 8)  # cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    descs = nv.get_imgs_feats_batch(frames, 8)
    wall = time.perf_counter() - t0
    fps = len(frames) / wall
    print(f"  NetVLAD at {frames[0].shape[0]}x{frames[0].shape[1]}: "
          f"{len(frames)} frames in batches of 8 in "
          f"{wall:.3f} s, {fps:.2f} frames/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    checks["NetVLAD: (frames, 4096) finite, unit rows"] = bool(
        descs.shape == (len(frames), cfg.whiten_dim)
        and np.isfinite(descs).all()
        and np.allclose(np.linalg.norm(descs, axis=1), 1.0, atol=1e-5))
    return nv, fps


def write_mosaic_scene(root: Path, n: int, seed: int, h: int = 720,
                       w: int = 1080):
    """``n`` frames of 40-pixel blocks in random colours (every frame a
    different image, unlike the slice-1 walk, whose frames share one
    gradient and differ only by noise: seeded weights cannot tell those
    apart above rounding) and identity poses; returns the frames."""
    import cv2

    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    frames = []
    for i in range(n):
        blocks = rng.integers(0, 256, (h // 40, w // 40, 3), dtype=np.uint8)
        frame = np.repeat(np.repeat(blocks, 40, axis=0), 40, axis=1)
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"), frame[..., ::-1])
        frames.append(frame)
    np.savetxt(root / "poses.txt", np.tile([0, 0, 0, 0, 0, 0, 1.0], (n, 1)))
    return frames


def retrieval_check(tmp: Path, encoders, checks: dict):
    """``VisualMap.create_and_load_map`` with each encoder on 16 mosaic
    frames at 720x1080; a mapping frame must retrieve itself."""
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.visual_map import VisualMap

    root = tmp / "mosaic"
    frames = write_mosaic_scene(root, 16, seed=3)
    mc = load_config().map_config
    q = 5
    for name, encoder in encoders:
        vm = VisualMap(mc, clip_encoder=encoder, device="cuda")
        t0 = time.perf_counter()
        vm.create_and_load_map(root)
        t_build = time.perf_counter() - t0
        sims = vm.descriptors @ encoder.get_img_feats(frames[q]).T
        top = np.argsort(sims[:, 0])[::-1][:2]
        hit = int(vm.retrieve(frames[q])[0])
        print(f"  retrieval with {name}: {vm.descriptors.shape} descriptors "
              f"cached in {t_build:.2f} s; frame {q} retrieves frame {hit} "
              f"(cosine {sims[top[0], 0]:.6f}, runner-up frame {top[1]} at "
              f"{sims[top[1], 0]:.6f})")
        checks[f"retrieval with {name}: a mapping frame retrieves "
               "itself"] = hit == q


def refinement_check(tmp: Path, sp, sp_cpu, checks: dict):
    """The textured-shift recipe through ``refine_pose`` with the
    full-width SuperPoint and the mutual-NN matcher, on the CPU and on
    the card: the 25 cm translation within 6 cm, the rotation within
    0.05."""
    import cv2

    from avlmaps_torch.config import load_config
    from avlmaps_torch.geometry.projection import get_sim_cam_mat
    from avlmaps_torch.geometry.transforms import pose_vec_to_tf
    from avlmaps_torch.map.visual_map import VisualMap

    h, w = REFINE_H, REFINE_W
    root = tmp / "refine"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    intr = get_sim_cam_mat(h, w)
    shift = int(round(intr[0, 0] * REFINE_TX / REFINE_DEPTH))
    tex = textured_canvas(np.random.default_rng(0), h, w + shift)
    cv2.imwrite(str(root / "rgb" / "000000.png"), tex[:, :w, ::-1])
    np.save(root / "depth" / "000000.npy",
            np.full((h, w), REFINE_DEPTH, np.float32))
    query = np.ascontiguousarray(tex[:, shift:w + shift])
    mc = load_config().map_config
    mc.cam_calib_mat = tuple(intr.reshape(-1))
    for device, ext in (("cpu", sp_cpu), ("cuda", sp)):
        vm = VisualMap(mc, str(root), superpoint=ext, device=device)
        vm.poses = np.stack([pose_vec_to_tf([0, 0, 0, 0, 0, 0, 1.0])])
        vm.descriptors = np.ones((1, 8), np.float32)
        n = len(vm._match_superpoint(query, 0)[0])
        cam = vm.refine_pose(query, 0, intr)
        ok = cam is not None
        if ok:
            ref = vm._ref_cam_tf(0)
            delta = cam[:3, 3] - ref[:3, 3]
            rot = float(np.abs(cam[:3, :3] - ref[:3, :3]).max())
            ok = bool(np.abs(delta - [REFINE_TX, 0, 0]).max() <= 0.06
                      and rot <= 0.05)
            print(f"  refine_pose on {device}: {n} mutual-NN matches, "
                  f"translation {np.round(delta, 4).tolist()} m (truth "
                  f"[{REFINE_TX}, 0, 0]), rotation max |d| {rot:.4f}")
        checks[f"refine_pose on {device}: 25 cm within 6 cm"] = ok


def image_query_check(enc, scene: Path, frames, rows, checks: dict):
    """``AVLMap.load_map`` with the visual map, ``index_image`` against the
    host formula, and the object (K7; K8 with the categories) x image goal
    on the card against the host argmax."""
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.avlmap import AVLMap
    from avlmaps_torch.ops import delivery as dlv

    for r in rows:
        r["fn"].launches = 0
    cfg = load_config()
    avl = AVLMap(cfg, clip_encoder=enc, area_clip_encoder=enc,
                 device="cuda")
    t0 = time.perf_counter()
    avl.load_map(scene)
    t_load = time.perf_counter() - t0
    vm = avl.vlmap
    q = frames[7]
    t0 = time.perf_counter()
    heat = avl.index_image(q)
    t_query = time.perf_counter() - t0
    cam, base_tf = avl.visual_map.localize_image(q)
    # the host formula (avlmaps_tpu/map/avlmap.py:231-240)
    avl.dataloader.from_habitat_tf(base_tf)
    row, col, _ = avl.dataloader.to_full_map_pose()
    pos = np.array([row, col, cfg.map_config.pose_info.camera_height
                    / cfg.params.cs], np.float32)
    host = np.clip(1.0 - 0.01 * np.linalg.norm(
        (vm.grid_pos.astype(np.float32) - pos)[:, :2], axis=1), 0.0, 1.0)
    moved = float(np.abs(cam[:3, 3] - avl.visual_map._ref_cam_tf(7)[:3,
                                                                     3]).max())
    print(f"  AVLMap.load_map with the visual map in {t_load:.2f} s; "
          f"index_image(frame 7) in {t_query * 1e3:.1f} ms (host clock): "
          f"pose cell ({row}, {col}), {moved:.4f} m from frame 7's camera, "
          f"{int((heat > 0).sum())} of {len(heat)} voxels with heat > 0")
    dev = avl.index_image(q, decay_rate=0.01, delivery="device")
    checks["index_image == the host formula, f32 and device"] = bool(
        np.array_equal(heat, host) and np.array_equal(dev.cpu().numpy(),
                                                      host))
    cats = MP3D[1:-1]
    avl.index_object("chair", init_categories=MP3D, delivery="device")
    labels = np.argmax(vm.scores_mat, axis=1)
    top = cats[int(np.bincount(labels, minlength=len(cats) + 1)[
        :len(cats)].argmax())]
    for label, obj in (
            ("K8", avl.index_object(top, init_categories=MP3D,
                                    decay_rate=0.01, delivery="device")),
            ("K7", avl.index_object("chair", decay_rate=0.01,
                                    delivery="device"))):
        gpos, val = dlv.fetch_np(*dlv.fused_goal_pick([obj, dev],
                                                      vm.grid_pos))
        fused = obj.cpu().numpy() * host
        print(f"  object ({label}) x image: goal {np.asarray(gpos).tolist()}"
              f", heat {float(val):.4f}")
        checks[f"object ({label}) x image goal == host argmax, heat > 0"] = \
            bool(np.array_equal(gpos, vm.grid_pos[int(np.argmax(fused))])
                 and abs(float(val) - float(fused.max())) <= 1e-6
                 and float(val) > 0)
    counts = {r["name"]: r["fn"].launches for r in rows}
    for r in rows:
        r["slice8_launches"] = r["fn"].launches
    print(f"  image query launches: {counts}")
    checks["K7 and K8 launched by the image query's fusion"] = min(
        counts.values()) >= 1


def multi_scale_check(frames, rows, checks: dict):
    """``multi_scale_features`` on one 720x1080 frame: the medium f32 LSeg
    card against CPU within 5e-3, and the ViT-L/16 bf16 LSeg on the card
    (K1-K3 launches = 24 x forwards, crops, ms a frame, pixels/s; each
    forward's crops through the fused and the plain route).  Returns the
    kernel rows of :func:`multi_scale_shape_checks`."""
    import torch

    from avlmaps_torch.models.lseg import (DEFAULT_SCALES, LSegConfig,
                                           LSegNet,
                                           cast_params_for_inference,
                                           init_params,
                                           multi_scale_features,
                                           normalize_image, plan_windows)

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for matmul or cuDNN")
    h, w = frames[0].shape[:2]
    x = torch.from_numpy(normalize_image(frames[0])[None].astype(np.float32))
    crops = 2 * sum(len(plan_windows(h, w, math.ceil(520 * s), 480)[4])
                    for s in DEFAULT_SCALES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cfg = LSegConfig.medium()
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cpu = LSegNet(cfg, device="cpu")
    cpu.load_state_dict(_cpu_state(net))
    with torch.no_grad():
        got = multi_scale_features(net, x.cuda()).cpu()
        want = multi_scale_features(cpu, x)
    err = float((got - want).abs().max())
    print(f"  medium f32 LSeg, 6 scales with flip ({crops} crops), "
          f"{h}x{w}: card vs CPU max |diff| {err:.3e} (tolerance 5e-3 + "
          "5e-3 * |CPU|)")
    checks["multi-scale medium LSeg: card == CPU within 5e-3"] = bool(
        torch.allclose(got, want, atol=5e-3, rtol=5e-3))
    del net, cpu, got, want

    cfg = LSegConfig.vitl16(torch.bfloat16)
    gen.manual_seed(0)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    net.eval().requires_grad_(False)
    forwards, batches = [], []

    def apply(batch):
        forwards.append(batch.shape[0])
        batches.append(batch)
        return net(batch)

    xc = x.cuda()
    for r in rows:
        r["fn"].launches = 0
    with torch.no_grad():
        out = multi_scale_features(apply, xc)
        counts = {r["name"]: r["fn"].launches for r in rows}
        ms = time_ms(lambda: multi_scale_features(net, xc), iters=3)
        dev_ms, launches, _ = profile_call(
            lambda: multi_scale_features(net, xc))
    for r in rows:
        r["slice8_launches"] = counts[r["name"]]
    print(f"  ViT-L/16 bf16 LSeg, 6 scales with flip: {len(forwards)} "
          f"forwards of {forwards} crops ({sum(forwards)} a frame), "
          f"{ms:.1f} ms a frame (CUDA events), {h * w * 1e3 / ms:.0f} "
          f"pixels/s, {dev_ms:.1f} ms of device work in {launches} kernel "
          f"launches (profiler); port kernels {counts}")
    checks["multi-scale ViT-L: K1-K3 launched 24 x forwards"] = all(
        n == LAYERS * len(forwards) for n in counts.values())
    checks["multi-scale ViT-L: crops a frame as planned"] = \
        sum(forwards) == crops
    checks["multi-scale ViT-L: (1, H, W, 512) finite"] = bool(
        out.shape == (1, h, w, cfg.out_dim) and torch.isfinite(out).all())
    del out
    before = {r["name"]: r["fn"].launches for r in rows}
    # each forward's crops again through the fused route (K1-K3) and the
    # plain route (no port kernel) on the same weights; per-pixel cosine
    # as the slice-1 one-crop check holds the card to the CPU: 24 bf16
    # blocks whose sums run in another order on each side
    cos = []
    with torch.no_grad():
        for batch in batches:
            fused = net(batch, upsample=False).float()
            for blk in net.backbone.blocks:
                blk.attn_impl = "xla"
            try:
                plain = net(batch, upsample=False).float()
            finally:
                for blk in net.backbone.blocks:
                    blk.attn_impl = "fused"
            cos.append(float(torch.nn.functional.cosine_similarity(
                fused, plain, dim=-1).min()))
            del fused, plain
    print("  ViT-L multi-scale forwards, fused route (K1-K3) against the "
          "plain route, per-pixel cosine min: " + ", ".join(
              f"{b} crops {c:.6f}" for b, c in zip(forwards, cos)))
    checks["multi-scale ViT-L: every forward's fused route == plain route "
           "(per-pixel cosine >= 0.999)"] = min(cos) >= 0.999
    del batches
    torch.cuda.empty_cache()
    shape_rows = multi_scale_shape_checks(forwards)
    for r in rows:
        r["fn"].launches = before[r["name"]]
    return shape_rows


def multi_scale_shape_checks(forwards):
    """K1, K3 and K2 at the multi-scale eval's crop batches that the
    batch-8 rows do not cover (M = b * T rows for b crops; attention on
    (b, 16, T, 64)) against their plain versions, with times, bounds and
    library times; the launches are the eval's at that batch (24 a
    forward)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    out = []
    for b in sorted(set(forwards) - {BATCH * CROPS}):
        for r in (k1_case(g, b * T, 3 * WIDTH), k3_case(g, b * T),
                  k2_case(g, b, T)[0]):
            r["launches"] = LAYERS * forwards.count(b)
            r["shape"] = (f"({b}, {HEADS}, {T}, 64)"
                          if r["name"] == "mha_oneshot_2d" else f"M={b * T}")
            print(f"  {r['name']} {r['shape']}: {_times(r)}, "
                  f"{r['launches']} launches in the multi-scale eval")
            out.append(r)
    torch.cuda.empty_cache()
    return out


def wav2clip_check(scene: Path, checks: dict):
    """Full-width Wav2CLIP on 10 of the sound map's clips, card against
    CPU."""
    from avlmaps_torch.config import load_config
    from avlmaps_torch.models.wav2clip import Wav2ClipEncoder
    from avlmaps_torch.utils import audio as au

    cc = load_config().sound_data_collect_params
    clips = []
    for seq in sorted((scene / "audio_video").iterdir())[:4]:
        audio, sr = au.read_wav(seq / "audio.wav", cc.sample_rate)
        _, tracks = au.segment_audio_with_silence(
            audio, cc.silence_duration_s, cc.silence_threshold, sr)
        clips += [au.get_five_second_context(t, 2.5, sr) for t in tracks]
    batch = np.stack(clips[:W2C_CLIPS]).astype(np.float32)
    w2c = Wav2ClipEncoder(seed=0, device="cuda")
    w2c_cpu = Wav2ClipEncoder(params=_cpu_state(w2c.model), device="cpu")
    card = _tf32_on("Wav2CLIP", (w2c.model.conv1, w2c.model.fc),
                    lambda: w2c.encode_device(batch).cpu().numpy(), checks)
    checks.update(_card_vs_cpu(f"Wav2CLIP embeddings, {len(batch)} clips",
                               card, w2c_cpu.encode_device(batch).numpy()))
    ms = time_ms(lambda: w2c.encode_device(batch), iters=5)
    dev_ms, launches, _ = profile_call(lambda: w2c.encode_device(batch))
    print(f"  Wav2CLIP ResNet-18 width {w2c.cfg.width}, {w2c.cfg.n_mels} "
          f"mels: a batch of {batch.shape} in {ms:.2f} ms (CUDA events), "
          f"{len(batch) * 1e3 / ms:.1f} clips/s, {dev_ms:.3f} ms of device "
          f"work in {launches} kernel launches (profiler)")
    return ms


def image_query_run(enc, scene: Path, tmp: Path, vit_rows, score_rows):
    """Slice 8 on the slice-1 scene: SuperPoint, SuperGlue and NetVLAD at
    full width against the CPU, retrieval with NetVLAD and CLIP, the
    textured refinement, ``AVLMap.index_image`` and its fused goal, the
    multi-scale LSeg eval and Wav2CLIP.  ``vit_rows`` are K1-K3's kernel
    rows, ``score_rows`` K7's and K8's; each gets its slice-8 count.
    Returns K1-K3's rows at the multi-scale eval's other shapes."""
    from avlmaps_torch.map.visual_map import rgb_to_gray_u8
    from avlmaps_torch.pipeline.loader import load_rgb

    t_phase = time.perf_counter()
    checks = {}
    frames = [load_rgb(p) for p in sorted((scene / "rgb").glob("*.png"))]
    try:
        import cv2
    except ImportError:
        print("  cv2: not installed on this machine")
    else:
        print(f"  cv2 {cv2.__version__} is installed")
        checks["rgb_to_gray_u8 == cv2.cvtColor on a scene frame"] = \
            np.array_equal(rgb_to_gray_u8(frames[0]),
                           cv2.cvtColor(frames[0], cv2.COLOR_RGB2GRAY))
    sp, sp_cpu, grays, _ = superpoint_check(frames, checks)
    superglue_check(sp, grays, checks)
    nv, _ = netvlad_check(frames, checks)
    retrieval_check(tmp, (("NetVLAD", nv), ("CLIP ViT-B/32", enc)), checks)
    del nv
    refinement_check(tmp, sp, sp_cpu, checks)
    image_query_check(enc, scene, frames, score_rows, checks)
    shape_rows = multi_scale_check(frames, vit_rows, checks)
    wav2clip_check(scene, checks)
    print(f"  slice 8 phase: {time.perf_counter() - t_phase:.1f} s wall")
    for name, ok in checks.items():
        print(f"  {'pass' if ok else 'FAIL'}: {name}")
    if not all(checks.values()):
        raise AssertionError("slice 8: the image query path failed")
    return shape_rows


# slice 9: the multi-floor build (32 720x1080 frames with global camera
# poses on two floors 3 m apart, 16 a floor; batch 8 = 16 crops a step, 4
# steps) and the robot on the slice-1 map
MF_FRAMES = 32
MF_FLOOR_GAP = 3.0
MF_BATCH = 8
MF_M = MF_BATCH * CROPS * T  # 14,416 token rows a forward
MF_PROBE_STRIDE = 50  # probe_bounds' default: every 5th frame, 50th point
MF_FEAT_TOL = 1e-5  # |d| <= tol + tol * |CPU| for the stand-in features


def write_two_floor_scene(root: Path, seed: int = 5) -> list:
    """write_scene's frames with global camera poses; returns the 4x4
    poses (:func:`two_floor_poses`)."""
    write_scene(root, MF_FRAMES, seed)
    return two_floor_poses()


def two_floor_poses() -> list:
    """Global camera poses (habitat axes, y up, camera 1.5 m above its
    floor): 16 frames a floor, the second floor 3 m above the first, each
    floor's walk 5 cm forward and 2 deg of yaw a frame."""
    from avlmaps_torch.geometry.transforms import pose_vec_to_tf

    tfs = []
    for i in range(MF_FRAMES):
        floor, k = divmod(i, MF_FRAMES // 2)
        th = np.deg2rad(2.0 * k)
        tfs.append(pose_vec_to_tf(np.array(
            [0.05 * k, 1.5 + MF_FLOOR_GAP * floor, -0.05 * k, 0.0,
             np.sin(th / 2), 0.0, np.cos(th / 2)])))
    return tfs


def probe_bounds_f64(mc, depth_paths, cam_tfs, stride: int,
                     margin: float = 1.0):
    """probe_bounds recomputed in numpy f64 throughout (the builder
    backprojects in f32): the same frames and points."""
    inv = np.linalg.inv(mc.calib_matrix())
    mins, maxs = np.full(3, np.inf), np.full(3, -np.inf)
    for i in range(0, len(depth_paths), max(1, stride // 10)):
        d = np.load(depth_paths[i]).astype(np.float64)
        h, w = d.shape
        ys, xs = np.mgrid[0:h, 0:w] + 0.5
        uv1 = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], 1)
        pc = (uv1 @ inv.T) * d.reshape(-1, 1)
        z = pc[:, 2]
        pc = pc[(z > mc.min_depth) & (z < 10.0)][::stride]
        tf = cam_tfs[i]
        pg = pc @ tf[:3, :3].T + tf[:3, 3]
        mins, maxs = np.minimum(mins, pg.min(0)), np.maximum(maxs, pg.max(0))
    pad = np.array([0.0, margin, 0.0])
    return mins - pad, maxs + pad


def standin_apply(device):
    """A fixed seeded 1x1 projection of the RGB to 512 channels in f32,
    built in place in one output tensor (the CPU's cost is its memory
    passes)."""
    import torch

    g = torch.Generator()
    g.manual_seed(9)
    p = torch.randn(3, FEAT, generator=g).to(device)

    def apply(x):
        out = x[..., 0:1] * p[0]
        out.addcmul_(x[..., 1:2], p[1])
        return out.addcmul_(x[..., 2:3], p[2])

    return apply


def multi_floor_run(net, tmp: Path, rows, k5_row, vit_rows):
    """Slice 9's build: ``VLMapBuilderMultiFloor`` with the ViT-L/16 LSeg
    on the card (K1-K4, the full sliding-window canvas), its bounds, its
    voxels against a stand-in build on the card and on the CPU, the HDF5
    round trip through ``VLMapMultiFloor.load_map``, and K1-K3 at the
    build's shapes.  Sets each row's ``slice9_launches`` to the build's
    count; returns the scene, the build's rows at the new shapes and the
    checks."""
    import torch

    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.vlmap_builder_multi_floor import (
        HABITAT2CAM_ROT, VLMapBuilderMultiFloor, VLMapMultiFloor)
    from avlmaps_torch.tools import trace_step

    t_phase = time.perf_counter()
    checks = {}
    scene = tmp / "two_floors"
    tfs = write_two_floor_scene(scene)
    rgb = sorted((scene / "rgb").glob("*.png"))
    depth = sorted((scene / "depth").glob("*.npy"))
    mc = load_config().map_config  # cs 0.05, capacity 1e6, 7776 points
    assert mc.cell_size == 0.05 and mc.capacity == CAPACITY

    def builder(apply, device, out=None):
        # out: another directory, to keep the ViT-L build's file in the
        # scene
        return VLMapBuilderMultiFloor(
            scene, mc, rgb, depth, tfs, lseg_apply=apply, feat_dim=FEAT,
            batch_size=MF_BATCH, seed=0, device=device,
            map_save_dir=None if out is None else tmp / out)

    # bounds: the probe (f32 points, f64 pose) against numpy f64
    b = builder(net, "cuda")
    lo, hi = b.probe_bounds(sample_stride=MF_PROBE_STRIDE)
    lo64, hi64 = probe_bounds_f64(mc, depth, [np.asarray(t) @ HABITAT2CAM_ROT
                                             for t in tfs], MF_PROBE_STRIDE)
    d_probe = float(max(np.abs(lo - lo64).max(), np.abs(hi - hi64).max()))
    gs, vh, n_rows, n_cols = b.grid_dims()
    print(f"  probe_bounds: pcd_min {np.round(lo, 4).tolist()} pcd_max "
          f"{np.round(hi, 4).tolist()}; max |d| against numpy f64 "
          f"{d_probe:.2e} m; grid {n_rows} x {n_cols} x {vh} -> gs {gs}")
    checks["probe_bounds == numpy f64 recomputation (1e-5 m)"] = \
        d_probe <= 1e-5
    checks["two floors 3 m apart widen the height range past 3 m"] = \
        hi[1] - lo[1] > MF_FLOOR_GAP

    # the ViT-L build, the main path: K1-K3 24 a forward, K4 once a step
    checks["TF32 off for matmul and cuDNN"] = not (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32)
    counted = rows[:4] + [k5_row] + vit_rows
    for r in counted:
        r["fn"].launches = 0
    # split the wall: the host's waits for the loader's next batch, and
    # the export + HDF5 save after the last step's device work
    waits, saves = [], []
    make_loader, save = b._make_loader, b._save

    def timed_loader(*args):
        it = iter(make_loader(*args))
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                waits.append(time.perf_counter() - t)
            yield batch

    def timed_save(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return save(*args)
        finally:
            saves.append(time.perf_counter() - t)

    b._make_loader, b._save = timed_loader, timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vit = b.create_global_map(progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    save_s, wait_s = sum(saves), sum(waits)
    for r in counted:
        r["slice9_launches"] = r["fn"].launches
    steps = math.ceil(MF_FRAMES / MF_BATCH)
    launches = {r["name"]: r["slice9_launches"] for r in counted}
    want = {"ln_matmul": LAYERS * steps, "mha_oneshot_2d": LAYERS * steps,
            "ln_mlp_residual": LAYERS * steps,
            "sorted_segment_scatter_add_split": steps,
            "sorted_segment_scatter_add": 0, "gelu_matmul": 0,
            "mha_bhtd": 0}
    print(f"  ViT-L build: {MF_FRAMES} frames in {wall:.2f} s "
          f"({MF_FRAMES / wall:.2f} frames/s incl. export and save), "
          f"{len(vit[0])} voxels; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    checks["launches: K1-K3 24 a forward, K4 once a step, K5 none"] = \
        all(launches.get(k) == v for k, v in want.items())
    with GATE.paused(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        builder(net, "cuda", out="mf_profiled").create_global_map(
            progress=False)
        torch.cuda.synchronize()
    dev_ms = trace_step.build_device_ms(prof, steps)
    host_ms = 1e3 * (wall - save_s) / steps
    print(f"  per step: host {host_ms:.1f} ms (the measured build's fusion "
          f"loop, up to the end of its last step's device work), of which "
          f"{1e3 * wait_s / steps:.1f} ms waiting for the loader's next "
          f"batch; device {dev_ms:.1f} ms (a profiled build of the same "
          f"frames); idle share of the loop {1 - dev_ms / host_ms:.3f}; "
          f"export + HDF5 save {1e3 * save_s:.1f} ms once "
          f"({save_s / wall:.3f} of the wall)")

    # the HDF5 file through VLMapMultiFloor.load_map
    m = VLMapMultiFloor(mc, device="cuda")
    ok = m.load_map(scene) and all(
        np.array_equal(getattr(m, k), v) for k, v in zip(
            ("grid_feat", "grid_pos", "weight", "occupied_ids", "grid_rgb"),
            vit)) and np.array_equal(m.pcd_min, lo) \
        and np.array_equal(m.pcd_max, hi) and m.cs == mc.cell_size \
        and m.mapped_iter_list == list(range(MF_FRAMES))
    checks["HDF5 round trip through VLMapMultiFloor.load_map"] = ok
    pos = vit[1]
    checks["grid_pos inside the probed grid, features finite"] = bool(
        pos.min() >= 0 and pos[:, 0].max() < gs and pos[:, 1].max() < gs
        and pos[:, 2].max() < vh and np.isfinite(vit[0]).all())

    # the geometry against the CPU: a stand-in network on both
    t0 = time.perf_counter()
    card = builder(standin_apply("cuda"), "cuda", out="mf_standin_card")
    card.pcd_min, card.pcd_max = lo, hi
    sc = card.create_global_map(progress=False)
    cpu = builder(standin_apply("cpu"), "cpu", out="mf_standin_cpu")
    cpu.pcd_min, cpu.pcd_max = lo, hi
    sp = cpu.create_global_map(progress=False)
    d_feat = float(np.abs(sc[0] - sp[0]).max())
    rel_w = float((np.abs(sc[2] - sp[2]) / sp[2]).max())
    print(f"  stand-in builds (card, CPU): {len(sc[0])} and {len(sp[0])} "
          f"voxels; max |feat d| {d_feat:.3e}; max weight rel d "
          f"{rel_w:.3e}; {time.perf_counter() - t0:.1f} s")
    checks["stand-in: grid_pos, occupied_ids card == CPU"] = \
        np.array_equal(sc[1], sp[1]) and np.array_equal(sc[3], sp[3])
    checks["stand-in: weight card == CPU (rtol 1e-5)"] = rel_w <= 1e-5
    checks[f"stand-in: features card == CPU ({MF_FEAT_TOL:g} + "
           f"{MF_FEAT_TOL:g} x |CPU|)"] = bool(
        (np.abs(sc[0] - sp[0]) <= MF_FEAT_TOL
         + MF_FEAT_TOL * np.abs(sp[0])).all())
    checks["ViT-L voxels == stand-in voxels"] = \
        np.array_equal(vit[1], sc[1]) and np.array_equal(vit[3], sc[3])
    del sc, sp, card, cpu

    # K1-K3 at the build's shapes against their plain versions
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    shape_rows = [k1_case(g, MF_M, 3 * WIDTH), k3_case(g, MF_M),
                  k2_case(g, MF_BATCH * CROPS, T)[0]]
    for r in shape_rows:
        r["launches"] = launches[r["name"]]
        r["shape"] = (f"({MF_BATCH * CROPS}, {HEADS}, {T}, 64)"
                      if r["name"] == "mha_oneshot_2d" else f"M={MF_M}")
        print(f"  {r['name']} {r['shape']}: {_times(r)}, {r['launches']} "
              "launches in the multi-floor build")
    torch.cuda.empty_cache()
    print(f"  slice 9 build phase: {time.perf_counter() - t_phase:.1f} s "
          "wall")
    return scene, shape_rows, checks


# slice 10: the row-sharded build and query (parallel/sharded.py).  The
# slice-1 scene (32 frames, batch 8 = 4 steps) on a mesh of the real card
# and on 4 virtual shards of it (capacity 1e6 / 4 + 1 = 250,001 rows a
# shard: S % 8 == 1, so K4 skips each shard's trash run), slice 9's
# two-floor scene on 4 virtual shards, and K7 on row shards
S10_BATCH = 8
S10_SHARDS = 4
S10_BF16_TOL = 2e-2  # the bf16 wire rounds each point's feature once
S10_F32_TOL = 1e-5  # the f32 wire: the single-device build's own sums


class _FusionOptions:
    """Every ShardedFusion a builder makes inside takes ``kw`` (the
    builders choose neither the wire format nor the routing) and is kept
    in ``made``."""

    def __init__(self, **kw):
        self.kw, self.made = kw, []

    def __enter__(self):
        from avlmaps_torch.parallel import sharded

        self.cls = cls = sharded.ShardedFusion

        def make(*args, **kw):
            f = cls(*args, **{**kw, **self.kw})
            self.made.append(f)
            return f

        sharded.ShardedFusion = make
        return self

    def __exit__(self, *exc):
        from avlmaps_torch.parallel import sharded

        sharded.ShardedFusion = self.cls


def _s10_held(name: str, got, want, tol, checks: dict) -> None:
    """``got`` against ``want`` (grid_feat, grid_pos, weight): the same
    voxels, weights within rtol 1e-5, features within tol + tol x |want|
    (printed only for ``tol=None``); slots may come in another order
    (each shard allocates its own)."""
    fg, pg, wg = got[:3]
    fw, pw, ww = want[:3]
    kg, kw = np.lexsort(pg.T), np.lexsort(pw.T)
    same = pg.shape == pw.shape and np.array_equal(pg[kg], pw[kw])
    checks[f"{name}: the same voxels"] = same
    if not same:
        print(f"  {name}: {len(pg)} voxels against {len(pw)}")
        return
    rel_w = float((np.abs(wg[kg] - ww[kw]) / ww[kw]).max())
    d = np.abs(fg[kg] - fw[kw])
    held = ("not held" if tol is None
            else f"tolerance {tol:g} + {tol:g} x |reference|")
    print(f"  {name}: {len(pg)} voxels equal; max weight rel d {rel_w:.3e}; "
          f"max |feat d| {float(d.max()):.3e} ({held})")
    checks[f"{name}: weights within rtol 1e-5"] = rel_w <= 1e-5
    if tol is not None:
        checks[f"{name}: features within {tol:g}"] = bool(
            (d <= tol + tol * np.abs(fw[kw])).all())


def _arrays(m):
    return m.grid_feat, m.grid_pos, m.weight, m.occupied_ids, m.grid_rgb


def _s10_builder(apply, scene: Path, out: Path, mesh=None,
                 batch: int = S10_BATCH):
    """``VLMapBuilder`` of the slice-1 scene saving into ``out``: a fresh
    build, not a resume of slice 1's map."""
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    mc, tfs = _map_setup()
    return VLMapBuilder(scene, mc, scene / "poses.txt", *_frames(scene),
                        *tfs, lseg_apply=apply, feat_dim=FEAT,
                        batch_size=batch, seed=0, half_res_apply=True,
                        device="cuda", mesh=mesh, map_save_dir=out)


def _s10_build(apply, scene: Path, out: Path, mesh=None,
               batch: int = S10_BATCH, **kw):
    """:func:`_s10_builder`'s map with ``kw`` for its ShardedFusion;
    returns the map, the builder and the fusions made."""
    with _FusionOptions(**kw) as opts:
        b = _s10_builder(apply, scene, out, mesh, batch)
        m = b.create_mobile_base_map(save_every=0, progress=False)
    return m, b, opts.made


def real_cards_run(net, scene: Path, tmp: Path, checks: dict) -> None:
    """(a) over the machine's cards (4, or 2 if fewer), one copy of the
    net on each, against the single-device build whose forward has a
    shard's shapes; prints that it did not run on a one-card machine."""
    import torch

    from avlmaps_torch.parallel import make_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print("  one card: (a) over real cards did not run")
        return
    k = 4 if n_cards >= 4 else 2
    copies = [copy.deepcopy(net).to(f"cuda:{i}") for i in range(k)]
    applies = [lambda x, c=c: c(x, upsample=False) for c in copies]
    t0 = time.perf_counter()
    m, b, _ = _s10_build(applies, scene, tmp / "slice10" / "real_cards",
                         make_mesh(k))
    wall = time.perf_counter() - t0
    ref, _, _ = _s10_build(lambda x: net(x, upsample=False), scene,
                           tmp / "slice10" / "single_real",
                           batch=S10_BATCH // k)
    print(f"  (a) {k} real cards: {b.build_stats['fps']:.2f} frames/s "
          f"(RateMeter), whole build {wall:.2f} s; {card_line()}")
    _s10_held(f"(a) {k} real cards bf16 wire", _arrays(m), _arrays(ref),
              S10_BF16_TOL, checks)


class _FuseInputs:
    """The first ``n`` calls of ``module.fuse_points`` (parallel/
    sharded.py's: one step's shards, in device order; map/
    vlmap_builder.py's: the first steps) record clones of their inputs,
    as they are handed over; the fusion goes on unchanged."""

    def __init__(self, n: int, module):
        self.n, self.module, self.got = n, module, []

    def __enter__(self):
        self.fuse = fuse = self.module.fuse_points

        def capture(state, *args, **kw):
            if len(self.got) < self.n:
                self.got.append([a.clone() for a in args])
                self.shape = dict(gs=kw["gs"], vh=kw["vh"],
                                  n_rows=kw.get("n_rows"),
                                  capacity=state.accum.shape[0] - 1)
            return fuse(state, *args, **kw)

        self.module.fuse_points = capture
        return self

    def __exit__(self, *exc):
        self.module.fuse_points = self.fuse


def shard_scatter_check(label: str, shards, row, *, gs: int, vh: int,
                        n_rows: int, capacity: int, launches: int) -> dict:
    """K4 or K5 (``row``) at a step's shape: each shard's captured inputs
    sorted into a fresh shard state (``n_rows`` of ``gs`` rows,
    ``capacity`` slots, so the points the shard does not own fill the
    trash run; ``n_rows`` None and one shard: a single-device step's),
    held against the plain version at 1e-4 + 1e-5 x |plain| and bitwise
    against the other kernel on the same batch; each shard's device time,
    and the times, library time and bound on the shard with the most
    owned rows.  Returns a ``more_shapes`` row."""
    import torch

    from avlmaps_torch.ops import segment_scatter as ss

    k4 = ss.sorted_segment_scatter_add_split
    k5 = ss.sorted_segment_scatter_add
    is_k4 = row["fn"] is k4
    name = "K4" if is_k4 else "K5"
    errs, dev_ms, owned = [], [], []
    for j, captured in enumerate(shards):
        sb = _sorted_step(captured, gs, vh, capacity, n_rows)
        update = torch.cat([sb.w[:, None] * sb.feats.float(), sb.aux], dim=1)
        base = torch.zeros(capacity + 1, ACCUM_W, device="cuda")
        n_real = int((sb.slots != capacity).sum())
        if is_k4:
            got = _uncounted(k4, base.clone(), sb.slots, sb.feats, sb.w,
                             sb.aux)
            want = ss.sorted_segment_scatter_add_split_ref(
                base.clone(), sb.slots, sb.feats, sb.w, sb.aux)
            other = _uncounted(k5, base.clone(), sb.slots, update)
        else:
            got = _uncounted(k5, base.clone(), sb.slots, update)
            want = ss.sorted_segment_scatter_add_ref(base.clone(), sb.slots,
                                                     update)
            before = k4.launches  # a check's launch, not the main path's
            other = ss.split_kernel(base.clone(), sb.slots, sb.feats, sb.w,
                                    sb.aux)
            k4.launches = before
        other_name = "K5" if is_k4 else "K4"
        errs.append(compare(
            f"{label} shard {j}: {name} on {sb.slots.numel()} rows, "
            f"{n_real} owned, {sb.slots.numel() - n_real} in the trash run",
            got[:capacity], want[:capacity], 1e-4, 1e-5))
        same = torch.equal(got[:capacity], other[:capacity])
        print(f"  {'pass' if same else 'FAIL'}: {label} shard {j}: {name} "
              f"== {other_name} bitwise on rows [0, {capacity})")
        if not same:
            raise AssertionError(f"{label} shard {j}: {name} and "
                                 f"{other_name} disagree")
        del got, want, other
        acc = base
        if is_k4:
            fn = lambda: k4(acc, sb.slots, sb.feats, sb.w,  # noqa: E731
                            sb.aux)
        else:
            fn = lambda: k5(acc, sb.slots, update)  # noqa: E731
        before = row["fn"].launches
        dev_ms.append(device_ms(fn))
        row["fn"].launches = before
        owned.append(n_real)
        del sb, update, acc, base
    j = max(range(len(shards)), key=owned.__getitem__)
    sb = _sorted_step(shards[j], gs, vh, capacity, n_rows)
    update = torch.cat([sb.w[:, None] * sb.feats.float(), sb.aux], dim=1)
    acc = torch.zeros(capacity + 1, ACCUM_W, device="cuda")
    idx = sb.slots.long()
    real = sb.slots[sb.slots != capacity]
    n_real, n_unique = int(real.numel()), int(torch.unique(real).numel())
    if is_k4:
        esz = sb.feats.element_size()
        b_ms, b_by = bound(2 * n_real * ACCUM_W,
                           n_real * (esz * FEAT + 4 + 4 * (ACCUM_W - FEAT)
                                     + 4) + n_unique * ACCUM_W * 8, PEAK_F32)
        fn = lambda: k4(acc, sb.slots, sb.feats, sb.w, sb.aux)  # noqa: E731
        plain = lambda: ss.sorted_segment_scatter_add_split_ref(  # noqa: E731
            acc, sb.slots, sb.feats, sb.w, sb.aux)
    else:
        b_ms, b_by = bound(n_real * ACCUM_W,
                           n_real * (4 * ACCUM_W + 4)
                           + n_unique * ACCUM_W * 8, PEAK_F32)
        fn = lambda: k5(acc, sb.slots, update)  # noqa: E731
        plain = lambda: ss.sorted_segment_scatter_add_ref(  # noqa: E731
            acc, sb.slots, update)
    lib = lambda: acc.index_add_(0, idx, update)  # noqa: E731
    before = row["fn"].launches
    out = {**{k: row[k] for k in ("name", "route", "source", "replaces")},
           "shape": (f"{label}: {sb.slots.numel()} rows a step, "
                     f"S={capacity + 1}" if n_rows is None else
                     f"{label}: {sb.slots.numel()} rows a shard, "
                     f"S={capacity + 1}, shard {j} of {len(shards)}"),
           "launches": launches, "max_abs_err": max(errs),
           "ms": time_ms(fn), "device_ms": dev_ms[j],
           "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lib), "library_device_ms": device_ms(lib),
           "shard_device_ms": dev_ms,
           "runs": run_lengths(sb.slots, capacity)}
    row["fn"].launches = before
    print(f"  {label}: {name} on shard {j} ({n_real} owned rows, "
          f"{n_unique} voxels): {_times(out)}; each shard's device ms "
          f"{[round(t, 4) for t in dev_ms]}; runs {out['runs']}; "
          f"{card_line()}")
    del sb, update, acc, idx
    torch.cuda.empty_cache()
    return out


class _DropLedger:
    """Wraps ``ShardedFusion.exchange`` under all-to-all routing: per
    sending shard, the valid points past the first ``cap`` of each owner
    in the order the sender made them (``cap`` derived anew from the
    payload's size, the mesh and ``a2a_slack``), and their summed weight:
    what the routing must drop and count."""

    def __init__(self, cls):
        self.cls, self.exchange = cls, cls.exchange
        self.dropped, self.lost_w = {}, 0.0

    def __enter__(self):
        import torch

        ledger, exchange = self, self.exchange

        def counted(fusion, payloads):
            n, rows = fusion.n_dev, fusion.rows_per_dev
            for i, (gid, _, _, alpha, valid) in enumerate(payloads):
                n_pts = gid.shape[0]
                cap = int(min(n_pts, -(-n_pts // n) * fusion.a2a_slack))
                cap = max(8, -(-cap // 8) * 8)
                owner = torch.clamp(gid[:, 0], 0, fusion.gs - 1) // rows
                late = torch.zeros_like(valid)
                for o in range(n):
                    mine = valid & (owner == o)
                    late |= mine & (torch.cumsum(mine, 0) > cap)
                ledger.dropped[i] = ledger.dropped.get(i, 0) + int(late.sum())
                ledger.lost_w += float(alpha[late].double().sum())
            return exchange(fusion, payloads)

        self.cls.exchange = counted
        return self

    def __exit__(self, *exc):
        self.cls.exchange = self.exchange


class _OpPrints:
    """A torch function mode that, once ``on`` is set, records every call
    with a tensor result: its name and the exact integer sums of the bits
    of its tensor inputs and outputs.  With ``ref`` (another run's
    records), each tensor is first cut to the rows of ``ref``'s tensor in
    the same place where only the leading dimension differs (the first
    crops of a larger batch); call number ``want`` keeps its first output
    so cut."""

    def __init__(self, ref=None, want: int = -1):
        from torch.overrides import TorchFunctionMode

        outer = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                res = func(*args, **(kwargs or {}))
                if outer.on:
                    outer.record(func, args, kwargs, res)
                return res

        self.mode = Mode()
        self.ref, self.want = ref, want
        self.on, self.calls, self.kept = False, [], None

    @staticmethod
    def _cut(t, shape):
        if (shape is not None and t.dim() == len(shape) and t.dim()
                and tuple(t.shape[1:]) == shape[1:] and t.shape[0] > shape[0]):
            return t[:shape[0]]
        return t

    @staticmethod
    def _bits(t) -> tuple:
        import torch

        t = t.detach().contiguous()
        if t.is_floating_point():
            t = t.view({8: torch.int64, 4: torch.int32,
                        2: torch.int16}[t.element_size()])
        return tuple(t.shape), int(t.long().sum())

    def record(self, func, args, kwargs, res) -> None:
        import torch

        def tensors(x):
            if isinstance(x, torch.Tensor):
                return [x]
            if isinstance(x, (list, tuple)):
                return [t for v in x for t in tensors(v)]
            if isinstance(x, dict):
                return [t for v in x.values() for t in tensors(v)]
            return []

        outs = tensors(res)
        if not outs:
            return
        i = len(self.calls)
        ref = self.ref[i] if self.ref and i < len(self.ref) else None

        def prints(ts, k):
            shapes = [s for s, _ in ref[k]] if ref else []
            return [self._bits(self._cut(t, shapes[j] if j < len(shapes)
                                         else None))
                    for j, t in enumerate(ts)]

        if i == self.want:
            self.kept = self._cut(outs[0], ref[2][0][0] if ref else None
                                  ).detach().clone()
        self.calls.append((getattr(func, "__name__", str(func)),
                           prints(tensors((args, kwargs)), 1),
                           prints(outs, 2)))


def forward_batch_probe(net, crops, per: int) -> dict:
    """Where the LSeg forward's dependence on the batch size sits: the
    decoder and head of ``net`` on the first ``per`` of ``crops`` alone
    and on all of them, call by call (every torch call from the decoder
    on, compared by exact bit sums over those ``per`` crops): the first
    call whose output differs, whether its inputs agree, and its output's
    max |d|.  Also whether one crop's output depends on another's at a
    fixed batch: with crop 0 replaced, every other crop's output must
    stay bit for bit."""
    import torch

    def run(x, ref=None, want=-1):
        rec = _OpPrints(ref, want)
        hook = net.decoder.register_forward_pre_hook(
            lambda *_: setattr(rec, "on", True))
        try:
            with torch.no_grad(), rec.mode:
                out = net(x, upsample=False)
        finally:
            hook.remove()
        return rec, out

    with torch.no_grad():  # caches filled, so both runs make one sequence
        net(crops[:per], upsample=False)
        net(crops, upsample=False)
    part, out_p = run(crops[:per])
    whole, out_w = run(crops, part.calls)
    # the first call whose output differs, or whose name or number of
    # outputs does (a call in micro-batches makes more calls on more
    # crops: the sequences part at its split, and no call is named then)
    first = next((i for i, (a, b) in enumerate(zip(whole.calls, part.calls))
                  if a[0] != b[0] or a[2] != b[2]), None)
    diverged = first is not None and (
        whole.calls[first][0] != part.calls[first][0]
        or len(whole.calls[first][2]) != len(part.calls[first][2]))
    res = dict(calls=len(part.calls),
               same_calls=[c[0] for c in whole.calls]
               == [c[0] for c in part.calls],
               output_d=float((out_w[:per].float() - out_p.float())
                              .abs().max()),
               cudnn_benchmark=torch.backends.cudnn.benchmark,
               first_call=None if diverged else first,
               sequences_part_at=first if diverged else None)
    if first is not None and not diverged:
        name, ins, _ = part.calls[first]
        b = run(crops[:per], want=first)[0].kept
        a = run(crops, part.calls, first)[0].kept
        res.update(first_call_name=name,
                   first_call_inputs_equal=ins == whole.calls[first][1],
                   first_call_input_shapes=[s for s, _ in ins],
                   first_call_d=(float((a.float() - b.float()).abs().max())
                                 if a.shape == b.shape else None))
    swapped = crops.clone()
    swapped[0] = crops[-1]
    with torch.no_grad():
        out_s = net(swapped, upsample=False)
    res["crops_independent"] = torch.equal(out_s[1:], out_w[1:])
    return res


def dpt_batch_check(net, crops, per: int, checks: dict) -> dict:
    """Part A as shipped (the fourth reassemble stage's strided conv one
    image at a time, ``models.lseg.dpt.conv_per_image``): the LSeg
    forward of all ``crops`` against that of their first ``per`` alone
    (:func:`forward_batch_probe`) and against the forward of ``crops`` in
    reverse order (every crop in another place) must be equal bit for
    bit, and no crop's output may depend on another's at a fixed batch;
    prints the probe's row with the decoder's device ms (the ``lseg.dpt``
    range) on the taps of all ``crops`` (a batch-8 sliding step) and of
    the throughput build's 16 whole canvases (``probes/dpt_batch.py``
    times the other candidates)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    canvases = torch.randn(THR_BATCH, 352, 544, 3, generator=g,
                           device="cuda")
    with torch.no_grad():
        probe = forward_batch_probe(net, crops, per)
        probe["reversed_d"] = float((net(crops, upsample=False).float()
                                     - net(crops.flip(0), upsample=False)
                                     .flip(0).float()).abs().max())
        taps = net.backbone(crops)
        thr_taps = net.backbone(canvases)
        gh = crops.shape[1] // 16
        tg = (canvases.shape[1] // 16, canvases.shape[2] // 16)
        probe["dpt_ms"] = device_ms(lambda: net.decoder(taps, gh, gh),
                                    iters=10)
        probe["dpt_ms_throughput"] = device_ms(
            lambda: net.decoder(thr_taps, *tg), iters=10)
    del taps, thr_taps, canvases
    print(f"  part A, the DPT as shipped ((c): the strided conv one "
          f"image at a time): {len(crops)} crops against their "
          f"first {per}: output max |d| {probe['output_d']:.3e}; against "
          f"the {len(crops)} in reverse order {probe['reversed_d']:.3e}; "
          f"first "
          f"call to differ {probe['first_call']} "
          f"{probe.get('first_call_name')}; call sequences part at "
          f"{probe['sequences_part_at']}; lseg.dpt device "
          f"{probe['dpt_ms']:.4f} ms on ({len(crops)}, {T}, {WIDTH}) taps, "
          f"{probe['dpt_ms_throughput']:.4f} ms at the throughput shape "
          f"({THR_BATCH} canvases of 352x544); crops independent "
          f"{probe['crops_independent']}; {card_line()}")
    checks[f"part A: the LSeg forward of {len(crops)} crops equals that of "
           f"their first {per}, bit for bit"] = probe["output_d"] == 0
    checks[f"part A: the LSeg forward of {len(crops)} crops equals that of "
           "the same crops in reverse order, bit for bit"] = \
        probe["reversed_d"] == 0
    checks["no crop's LSeg output depends on another crop's at a fixed "
           "batch"] = probe["crops_independent"]
    return probe


def sharded_build_run(net, scene: Path, mf_scene: Path, tmp: Path, rows,
                      k5_row, checks: dict) -> dict:
    """Slice 10's builds while the ViT-L net lives: ``VLMapBuilder(mesh=)``
    on the slice-1 scene over the real card and over 4 virtual shards,
    each held against the single-device build whose forward has the
    shard's shapes (bf16 and f32 wires): batch 8 for one shard, batch 2
    for four, and the 4-shard builds to the batch-8 build as well, since
    the forward no longer depends on the batch (:func:`dpt_batch_check`
    holds it bit for bit); K4 on
    the 4-shard step's inputs against its plain version; the all-to-all
    routing, lossless at slack 4 and at slacks 2 and 1 a subset whose
    drops each sender counts exactly; ``VLMapBuilderMultiFloor(mesh=)``
    on slice 9's scene at batch 32 (8 frames a shard: slice 9's forward,
    and K5 on > 100,000 gathered rows, held to its plain version on that
    step's inputs) against slice 9's build; a warm sharded step under
    ``set_sync_debug_mode("error")``; the exchange's bytes and time;
    ``dryrun_multichip`` on 4 virtual shards.  Sets K1-K5's
    ``slice10_launches`` from the 4-shard build; returns the printed
    numbers, with the K4/K5 rows at the shard shapes under
    ``scatter_rows``."""
    import torch

    from avlmaps_torch.map.vlmap_builder import sample_pixels
    from avlmaps_torch.map.vlmap_builder_multi_floor import (
        VLMapBuilderMultiFloor, load_multi_floor_map)
    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.parallel import make_mesh
    from avlmaps_torch.parallel.dryrun import dryrun_multichip
    from avlmaps_torch.parallel import sharded
    from avlmaps_torch.parallel.sharded import ShardedFusion
    from avlmaps_torch.pipeline.loader import PrefetchLoader
    from avlmaps_torch.pipeline.transport import make_canvas_transform

    t_phase = time.perf_counter()
    mc = _map_setup()[0]
    steps = N_FRAMES // S10_BATCH
    virtual = make_mesh(devices=["cuda:0"] * S10_SHARDS)
    out = tmp / "slice10"
    numbers = {"card": card_line()}

    def apply(x):
        return net(x, upsample=False)

    def build(name, mesh=None, batch=S10_BATCH, **kw):
        return _s10_build(apply, scene, out / name, mesh, batch, **kw)

    # the references: the single-device builds whose forward has each
    # mesh's shard shapes (the same draws: the sampler goes frame by frame)
    per_shard = S10_BATCH // S10_SHARDS
    ref = _arrays(build("single")[0])
    refs = {"mesh1": ref, "mesh4": _arrays(build(
        "single_per_shard", batch=per_shard)[0])}
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    crops = torch.randn(S10_BATCH * CROPS, 480, 480, 3, generator=g,
                        device="cuda")
    with torch.no_grad():
        whole = net(crops, upsample=False).float()
        parts = torch.cat([net(c, upsample=False).float()
                           for c in crops.split(per_shard * CROPS)])
        vit = net.backbone(crops)
        vit_parts = [net.backbone(c) for c in crops.split(per_shard * CROPS)]
    d_vit = max(float((t.float() - torch.cat([p[i] for p in vit_parts])
                       .float()).abs().max()) for i, t in enumerate(vit))
    numbers["forward_batch_dependence"] = dict(
        vit_taps=d_vit, output=float((whole - parts).abs().max()))
    print(f"  the LSeg forward of {S10_BATCH * CROPS} crops against "
          f"{S10_SHARDS} forwards of {per_shard * CROPS}: ViT taps max |d| "
          f"{d_vit:.3e}, output max |d| "
          f"{numbers['forward_batch_dependence']['output']:.3e}")
    checks[f"the LSeg forward of {S10_BATCH * CROPS} crops equals "
           f"{S10_SHARDS} forwards of {per_shard * CROPS}, bit for bit"] = \
        numbers["forward_batch_dependence"]["output"] == 0
    del whole, parts, vit, vit_parts
    numbers["forward_batch_probe"] = dpt_batch_check(
        net, crops, per_shard * CROPS, checks)
    del crops

    # (a) a mesh of the real card and 4 virtual shards: the loop on the host
    # clock up to the export, launches, a profiled rebuild, the default
    # bf16 wire against the single-device build
    counted = rows[:4] + [k5_row]
    export, loop_end = ShardedFusion.export, []

    def timed_export(self):
        torch.cuda.synchronize()
        loop_end.append(time.perf_counter())
        return export(self)

    maps = {}
    for label, mesh in (("mesh1", make_mesh(1)), ("mesh4", virtual)):
        _zero(counted)
        loop_end.clear()
        ShardedFusion.export = timed_export
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, b, _ = build(label, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ShardedFusion.export = export
        counts = _counts(counted)
        n = mesh.size
        want = {"ln_matmul": LAYERS * n * steps,
                "mha_oneshot_2d": LAYERS * n * steps,
                "ln_mlp_residual": LAYERS * n * steps,
                "sorted_segment_scatter_add_split": n * steps,
                "sorted_segment_scatter_add": 0}
        checks[f"(a) {label}: K1-K3 24 a shard forward, K4 once a shard "
               "step, K5 none"] = counts == want
        if label == "mesh4":
            for r in counted:
                r["slice10_launches"] = r["fn"].launches
        host_ms = (loop_end[0] - t0) * 1e3 / steps
        dev_ms = profile_build(_s10_builder(
            apply, scene, out / f"{label}_profiled", mesh), steps)
        k4_ms = path_ms("segment_scatter_kernel")
        numbers[label] = dict(
            frames_s=N_FRAMES / (loop_end[0] - t0), host_ms=host_ms,
            device_ms=dev_ms, idle=1 - dev_ms / host_ms,
            ratemeter_fps=b.build_stats["fps"], wall_s=wall,
            k4_ms_a_launch=k4_ms)
        print(f"  {label} ({n} shard{'s' if n > 1 else ''}): "
              f"{numbers[label]['frames_s']:.2f} frames/s, host "
              f"{host_ms:.1f} ms a step (loop to the export), device "
              f"{dev_ms:.1f} ms a step (profiled rebuild), idle share "
              f"{1 - dev_ms / host_ms:.3f}; RateMeter "
              f"{b.build_stats['fps']:.2f} frames/s; whole build "
              f"{wall:.2f} s; K4 {k4_ms:.4f} ms a shard step; launches "
              f"{counts}; {numbers['card']}")
        maps[label] = _arrays(m)
        _s10_held(f"(a) {label} bf16 wire", maps[label], refs[label],
                  S10_BF16_TOL, checks)
    # the forward no longer depends on the batch (part A), so the 4-shard
    # build is also held to the batch-8 build: the bf16 wire at its
    # rounding, the f32 wire at the single-device build's own sums
    _s10_held("(a) mesh4 against the batch-8 build", maps["mesh4"], ref,
              S10_BF16_TOL, checks)
    for label, mesh in (("mesh1", make_mesh(1)), ("mesh4", virtual)):
        with _FuseInputs(mesh.size, sharded) as step1:
            m, _, _ = build(label + "_f32", mesh, payload_dtype=torch.float32)
        _s10_held(f"(a) {label} f32 wire", _arrays(m), refs[label],
                  S10_F32_TOL, checks)
    _s10_held("(a) mesh4 f32 wire against the batch-8 build", _arrays(m),
              ref, S10_F32_TOL, checks)
    # K4 at a shard's shape: the 4-shard build's first step (the f32
    # wire's: the bf16 wire's rows, slots and trash run, the features
    # unrounded), 3/4 of each shard's rows in its trash run
    scatter = [shard_scatter_check(
        f"(a) {S10_SHARDS}-shard step", step1.got, rows[3],
        launches=rows[3]["slice10_launches"], **step1.shape)]
    del step1
    real_cards_run(net, scene, tmp, checks)

    # (b) all-to-all: lossless at slack 4; at slacks 2 and 1 a subset,
    # each sender's drops counted exactly (slack 1 must drop)
    m, b, _ = build("a2a_slack4", virtual, payload_routing="all_to_all",
                    a2a_slack=4.0)
    checks["(b) all_to_all at slack 4 == the 4-shard all-gather map, "
           "bit for bit, nothing dropped"] = all(
        np.array_equal(x, y) for x, y in zip(_arrays(m), maps["mesh4"])) \
        and b.build_stats["points_dropped"] == 0
    have = {tuple(p) for p in maps["mesh4"][1]}
    w_all = float(maps["mesh4"][2].astype(np.float64).sum())
    for slack in (2.0, 1.0):
        with _DropLedger(ShardedFusion) as ledger:
            m, b, made = build(f"a2a_slack{slack:g}", virtual,
                               payload_routing="all_to_all",
                               a2a_slack=slack)
        per_shard = [int(st.n_dropped) for st in made[0].states]
        want = [ledger.dropped[i] for i in range(S10_SHARDS)]
        subset = all(tuple(p) in have for p in m.grid_pos)
        lost = w_all - float(m.weight.astype(np.float64).sum())
        print(f"  (b) all_to_all at slack {slack:g}: {len(m.grid_pos)} of "
              f"{len(have)} voxels; n_dropped by sending shard {per_shard}, "
              f"points past a full bucket {want}; weight lost {lost:.6g} "
              f"against the dropped points' {ledger.lost_w:.6g}")
        numbers[f"a2a_slack{slack:g}"] = dict(
            voxels=len(m.grid_pos), all_gather_voxels=len(have),
            n_dropped=per_shard, weight_lost=lost,
            dropped_weight=ledger.lost_w)
        checks[f"(b) all_to_all at slack {slack:g}: a subset of the "
               "voxels"] = subset
        checks[f"(b) all_to_all at slack {slack:g}: each sender's n_dropped "
               "== its points past a full bucket"] = per_shard == want
        checks[f"(b) all_to_all at slack {slack:g}: the map lost the "
               "dropped points' weight (rtol 1e-5)"] = \
            abs(lost - ledger.lost_w) <= 1e-5 * w_all
        if slack == 1.0:
            checks["(b) all_to_all at slack 1 drops points"] = \
                sum(per_shard) > 0 and ledger.lost_w > 0

    # (c) the multi-floor build on 4 virtual shards against slice 9's: 8
    # frames a shard, slice 9's forward shapes; 4 x 62,208 gathered rows a
    # shard take K5
    mf_ref = load_multi_floor_map(mf_scene / "vlmap_multi_floor"
                                  / "vlmaps_multi_floor.h5df")
    mb = VLMapBuilderMultiFloor(
        mf_scene, mc, sorted((mf_scene / "rgb").glob("*.png")),
        sorted((mf_scene / "depth").glob("*.npy")), two_floor_poses(),
        lseg_apply=net, feat_dim=FEAT, batch_size=MF_BATCH * S10_SHARDS,
        seed=0, mesh=virtual, map_save_dir=out / "multi_floor")
    _zero(counted)
    t0 = time.perf_counter()
    with _FuseInputs(S10_SHARDS, sharded) as mf_step1:
        got = mb.create_global_map(progress=False)
    counts = _counts(counted)
    gs9, gs = mf_ref[4].shape[0], got[3].shape[0]
    print(f"  (c) multi-floor on {S10_SHARDS} shards, batch "
          f"{MF_BATCH * S10_SHARDS}: gs {gs9} -> {gs}, "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    checks["(c) multi-floor gs padded to a multiple of 4"] = \
        gs == -(-gs9 // S10_SHARDS) * S10_SHARDS
    steps_mf = math.ceil(MF_FRAMES / (MF_BATCH * S10_SHARDS))
    checks["(c) multi-floor: K1-K3 24 a shard forward, K5 once a shard "
           "step, K4 none"] = counts == {
        "ln_matmul": LAYERS * S10_SHARDS * steps_mf,
        "mha_oneshot_2d": LAYERS * S10_SHARDS * steps_mf,
        "ln_mlp_residual": LAYERS * S10_SHARDS * steps_mf,
        "sorted_segment_scatter_add_split": 0,
        "sorted_segment_scatter_add": S10_SHARDS * steps_mf}
    _s10_held("(c) multi-floor, 4 shards vs slice 9", got, mf_ref[1:4],
              S10_BF16_TOL, checks)
    # K5 at a shard's shape: the two-floor build's first step
    scatter.append(shard_scatter_check(
        f"(c) {S10_SHARDS}-shard two-floor step", mf_step1.got, k5_row,
        launches=counts["sorted_segment_scatter_add"], **mf_step1.shape))
    del mf_step1

    # (e) a warm 4-shard step makes no host sync; the exchange's bytes and
    # copy time (concatenations on one card: no link is crossed)
    h, w = 720, 1080
    height, width, _, _, _ = plan_windows(h, w)
    n_pts = mc.point_budget(h, w)
    rng = np.random.default_rng(0)
    transform = make_canvas_transform(
        lambda nb: sample_pixels(rng, h, w, mc.depth_sample_rate, n_pts, nb),
        (height, width))
    rgb, depth = _frames(scene)
    batch = next(iter(PrefetchLoader(
        rgb[:S10_BATCH], depth[:S10_BATCH], [np.eye(4)] * S10_BATCH,
        batch_size=S10_BATCH, normalize=False, transform=transform,
        device="cuda")))
    args = (batch.canvas, batch.z_mm, batch.rgb_pts, batch.pose_tf,
            batch.sample_idx, torch.ones(S10_BATCH, dtype=torch.bool,
                                         device="cuda"))
    for routing in ("all_gather", "all_to_all"):
        fusion = ShardedFusion(
            virtual, gs=mc.gs, cs=mc.cs, vh=mc.vh, feat_dim=FEAT,
            capacity=mc.capacity, calib_mat=mc.calib_matrix(),
            image_hw=(h, w), lseg_apply=apply, min_depth=mc.min_depth,
            max_depth=mc.max_depth, half_res_apply=True, transport="canvas",
            payload_routing=routing)
        with torch.no_grad():
            fusion.step(*args)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fusion.step(*args)
                synced = None
            except RuntimeError as e:
                synced = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            payloads = fusion.payloads(*args)
            sent = sum(t.numel() * t.element_size()
                       for p in payloads for t in p)
            received = sum(t.numel() * t.element_size()
                           for p in fusion.exchange(payloads)[0]
                           for t in p)
            copy_ms = time_ms(lambda: fusion.exchange(payloads))
            copy_dev = device_ms(lambda: fusion.exchange(payloads))
        checks[f"(e) a warm 4-shard {routing} step makes no host sync"] = \
            synced is None
        numbers[routing] = dict(payload_bytes=sent, received_bytes=received,
                                exchange_ms=copy_ms,
                                exchange_device_ms=copy_dev)
        print(f"  (e) {routing}: warm step under set_sync_debug_mode("
              f"'error') {'passed' if synced is None else synced}; payload "
              f"{sent} bytes a step from the shards, {received} bytes "
              f"fused after the exchange (features f32 again); exchange "
              f"{copy_ms:.3f} ms (CUDA events), device {copy_dev:.3f} ms "
              f"(profiler); {numbers['card']}")
        del fusion, payloads
    del batch, args
    torch.cuda.empty_cache()

    # (g) the port's dry run of the sharded program at tiny shapes (it
    # raises on a failure)
    numbers["dryrun"] = dryrun_multichip(S10_SHARDS,
                                         devices=["cuda:0"] * S10_SHARDS)
    numbers["scatter_rows"] = scatter
    print(f"  slice 10 build phase: {time.perf_counter() - t_phase:.1f} s "
          "wall")
    return numbers


def sharded_query_run(enc, scene: Path, k7_row, checks: dict) -> dict:
    """Slice 10's query: ``VLMap.index_map_sharded`` on the slice-1 map
    over 4 virtual shards against one K7 launch with the same flags, and
    ``sharded_score_argmax`` at 1e6 x 512, C = 22, against one K7 launch
    on every row; sets K7's ``slice10_launches`` and times the sharded K7
    against the single launch."""
    import torch

    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.vlmap import VLMap
    from avlmaps_torch.ops import similarity as sim
    from avlmaps_torch.parallel import make_mesh, sharded_score_argmax

    virtual = make_mesh(devices=["cuda:0"] * S10_SHARDS)
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    x = torch.randn(N_VOX, FEAT, generator=g, device="cuda")
    t = torch.randn(22, FEAT, generator=g, device="cuda")
    vm = VLMap(load_config().map_config, clip_encoder=enc, device="cuda")
    if not vm.load_map(scene):
        raise AssertionError("the slice-1 map did not load")
    k7_row["fn"].launches = 0
    mask = vm.index_map_sharded(virtual, "chair")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = sharded_score_argmax(virtual, x, t)
    host_ms = (time.perf_counter() - t0) * 1e3
    k7_row["slice10_launches"] = k7_row["fn"].launches

    text = torch.from_numpy(enc.get_text_feats_multiple_templates(
        ["chair", "other"])).cuda()
    want = sim.score_argmax(torch.from_numpy(vm.grid_feat).cuda(), text,
                            normalize_map=False, normalize_text=False)
    want = want.cpu().numpy() == 0
    one = sim.score_argmax(x, t, True, True).cpu().numpy()
    checks["(d) index_map_sharded == one K7 launch, every row"] = \
        np.array_equal(mask, want)
    checks["(d) sharded_score_argmax 1e6 x 512, C = 22 == one K7 launch, "
           "every row"] = np.array_equal(labels, one)
    per = N_VOX // S10_SHARDS
    shards = [x[i * per:(i + 1) * per] for i in range(S10_SHARDS)]

    def sharded():
        return [sim.score_argmax(s, t, True, True) for s in shards]

    def single():
        return sim.score_argmax(x, t, True, True)

    out = dict(index_voxels=int(mask.sum()), map_voxels=len(mask),
               sharded_ms=time_ms(sharded), sharded_device_ms=device_ms(
                   sharded, per_call=S10_SHARDS), single_ms=time_ms(single),
               single_device_ms=device_ms(single, per_call=1),
               sharded_call_host_ms=host_ms,
               launches=k7_row["slice10_launches"], card=card_line())
    print(f"  (d) index_map_sharded('chair'): {out['index_voxels']} of "
          f"{out['map_voxels']} voxels, equal to one K7 launch; "
          f"sharded_score_argmax at 1e6 x 512, C=22 on 4 shards equal to "
          f"one launch on every row; K7 launches {out['launches']}")
    print(f"  (f) K7 on 4 row shards {out['sharded_ms']:.4f} ms (device "
          f"{out['sharded_device_ms']:.4f}) against one launch "
          f"{out['single_ms']:.4f} ms (device {out['single_device_ms']:.4f}); "
          f"sharded_score_argmax with its label copy {host_ms:.1f} ms on the "
          f"host clock; {out['card']}")
    del x, t, shards
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _clip_of(encoder):
    """Every VLMap made inside takes ``encoder`` as its CLIP."""
    from avlmaps_torch.map.vlmap import VLMap

    original = VLMap._init_clip

    def patched(self, clip_version="ViT-B/32"):
        self.clip_encoder = encoder
        return encoder

    VLMap._init_clip = patched
    try:
        yield
    finally:
        VLMap._init_clip = original


def _free_cells(robot):
    """The free cells of the planner's obstacle map (the customised
    crop) nearest its centre and farthest from that, on the full map."""
    dl = robot.vlmaps_dataloader
    free = np.argwhere(robot.nav.obs_map == 1)
    d2 = ((free - np.array(robot.nav.obs_map.shape) / 2) ** 2).sum(1)
    near = free[int(np.argmin(d2))]
    far = free[int(np.argmax(((free - near) ** 2).sum(1)))]
    return [(int(r + dl.rmin), int(c + dl.cmin)) for r, c in (near, far)]


def program(top: str, second: str) -> str:
    """The short ``robot.*`` program the smoke runs through
    ``execute_code``."""
    return (f"robot.move_to_object({second!r})\nrobot.turn(90)\n"
            f"robot.move_forward(1.0)\nrobot.face({top!r})\n")


def robot_run(enc, scene: Path, mf_scene: Path, tmp: Path, score_rows,
              checks: dict):
    """Slice 9's robot on the slice-1 map: ``HabitatLanguageRobot`` with
    the kinematic simulator on the card and on the CPU from the same
    start, ``setup_scene`` (K8 at C = 41, the customised obstacle map with
    K7, the native visgraph of the gs = 1000 crop), ``move_to_object``,
    ``get_map_3d``, ``execute_code``, the fused goal pick with no host
    sync, and ``VLMapMultiFloor.index_map`` (K7) and ``get_pos`` (K8) on
    the multi-floor map against the CPU; then the port's CLIs in-process.
    ``score_rows`` (K7, K8) get their slice-9 counts added."""
    import os

    import torch

    from avlmaps_torch.application import generate_obstacle_map as cli_obs
    from avlmaps_torch.application import index_map as cli_index
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.vlmap_builder_multi_floor import VLMapMultiFloor
    from avlmaps_torch.models.clip import ClipEncoder
    from avlmaps_torch.nav.visgraph import VisGraph
    from avlmaps_torch.ops import delivery as dlv
    from avlmaps_torch.ops import similarity as sim
    from avlmaps_torch.ops.heatmap import heatmap_from_mask_3d
    from avlmaps_torch.robot import HabitatLanguageRobot, KinematicSimulator
    from avlmaps_torch.utils.categories import mp3dcat

    t_phase = time.perf_counter()
    cpu_enc = ClipEncoder.from_config(enc.cfg, params=_cpu_state(enc.model),
                                      device="cpu")
    # the CPU robot scores the card's text features, moved to the host
    # (the text tower itself is held to the CPU in slice 2)
    cpu_enc._landmark_feats = lambda names, multiple, avg: \
        enc._landmark_feats(names, multiple, avg).cpu()
    for r in score_rows:
        r["fn"].launches = 0

    # VLMapMultiFloor.index_map (K7) on the multi-floor map, card vs CPU
    mc = load_config().map_config
    mf = VLMapMultiFloor(mc, clip_encoder=enc, device="cuda")
    mf_cpu = VLMapMultiFloor(mc, clip_encoder=cpu_enc, device="cpu")
    assert mf.load_map(mf_scene) and mf_cpu.load_map(mf_scene)
    k7 = sim.score_argmax.launches
    mask = mf.index_map("chair", with_init_cat=False)
    k7 = sim.score_argmax.launches - k7
    want = mf_cpu.index_map("chair", with_init_cat=False)
    text = cpu_enc._landmark_feats(["chair", "other"], True, 0)
    ref = sim.score_features_ref(torch.from_numpy(mf.grid_feat), text)
    clear = _clear_rows(ref).numpy()
    print(f"  VLMapMultiFloor.index_map('chair'): {int(mask.sum())} of "
          f"{len(mask)} voxels (K7 {k7}x); {int((~clear).sum())} near ties; "
          f"{int((mask != want).sum())} differ from the CPU path")
    checks["multi-floor index_map by K7 == CPU on clear rows"] = \
        k7 == 1 and np.array_equal(mask[clear], want[clear])

    # VLMapMultiFloor.get_pos (K8 at C = 41, the pooling along y-up) of
    # the most frequent category that no near-tie row holds in its top two
    k8 = sim.score_features.launches
    mf.init_categories(mp3dcat)
    k8 = sim.score_features.launches - k8
    mf_cpu.init_categories(mp3dcat)
    s_cpu = np.sort(mf_cpu.scores_mat, axis=1)
    tie = s_cpu[:, -1] - s_cpu[:, -2] <= 1e-5 * np.abs(s_cpu[:, -1])
    tied = set(np.argsort(mf_cpu.scores_mat[tie], axis=1)[:, -2:].ravel())
    counts = np.bincount(np.argmax(mf.scores_mat, axis=1),
                         minlength=len(mp3dcat) + 1)[:len(mp3dcat)]
    name = next((mp3dcat[i] for i in np.argsort(-counts, kind="stable")
                 if counts[i] and i not in tied), None)
    if name is None:
        raise AssertionError("slice 9: every labelled category of the "
                             "multi-floor map is in a near tie")
    t0 = time.perf_counter()
    got = mf.get_pos(name)
    pos_ms = 1e3 * (time.perf_counter() - t0)
    want = mf_cpu.get_pos(name)
    same = all(len(a) == len(b) and all(
        np.array_equal(np.asarray(u), np.asarray(v)) for u, v in zip(a, b))
        for a, b in zip(got, want))
    print(f"  VLMapMultiFloor.get_pos({name!r}) after init_categories "
          f"(K8 {k8}x at C = {len(mp3dcat) + 1}; {int(tie.sum())} near-tie "
          f"rows): {len(got[1])} islands, {pos_ms:.1f} ms on the host "
          f"clock; card == CPU: {same}")
    checks["multi-floor get_pos (K8, pooling) == CPU, islands found"] = \
        k8 == 1 and same and len(got[1]) > 0

    # the robot on the slice-1 map, laid out as vlmaps_dataset/<scene>
    root = tmp / "robot"
    (root / "vlmaps_dataset").mkdir(parents=True)
    os.symlink(scene, root / "vlmaps_dataset" / scene.name)
    cfg = load_config()
    cfg.data_paths.avlmaps_data_dir = str(root)
    runs = {}
    for key, dev, encoder in (("card", "cuda", enc),
                              ("host", "cpu", cpu_enc)):
        bot = HabitatLanguageRobot(cfg, sim=KinematicSimulator(
            cfg.params.forward_dist, cfg.params.turn_angle), device=dev)
        t0 = time.perf_counter()
        with _clip_of(encoder):
            bot.setup_scene(0)
        setup_s = time.perf_counter() - t0
        out = {"setup_s": setup_s, "core": bot.nav.visgraph.core,
               "scores": bot.map.scores_mat}
        start, far = (_free_cells(bot) if key == "card" else
                      (runs["card"]["start"], runs["card"]["far_cell"]))
        labels = np.argmax(bot.map.scores_mat, axis=1)
        if key == "card":
            # the most frequent category, and the next one whose nearest
            # island lies more than 3 cells from the start
            counts = np.bincount(labels, minlength=len(mp3dcat) + 1)
            order = [mp3dcat[i] for i in
                     np.argsort(-counts[:len(mp3dcat)], kind="stable")
                     if counts[i]]
            top = order[0]
            second = next((n for n in order[1:] if math.dist(
                bot.map.get_nearest_pos(start, n), start) > 3), None)
            if second is None:
                raise AssertionError("slice 9: no second category has an "
                                     "island away from the robot's start")
        else:
            top, second = runs["card"]["top"], runs["card"]["second"]
        out.update(start=start, far_cell=far, top=top, second=second)
        for name in (second, top, "far"):
            bot.vlmaps_dataloader.from_full_map_pose(*start, 0.0)
            bot.set_agent_state(bot.vlmaps_dataloader.to_habitat_tf())
            bot.empty_recorded_actions()
            target = (far if name == "far" else
                      bot.map.get_nearest_pos(bot.curr_pos_on_map, name))
            # the planner clamps a target on an obstacle to the nearest
            # free cell: the path's end is the goal the robot can reach
            t0 = time.perf_counter()
            path = bot.nav.plan_to(bot.curr_pos_on_map, target)
            plan_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            if name == "far":
                bot.move_to(target)
            else:
                bot.move_to_object(name)
            move_ms = 1e3 * (time.perf_counter() - t0)
            actions = list(bot.get_recorded_actions())
            bot._set_nav_curr_pose()
            out[name] = dict(target=[float(v) for v in target],
                             goal=[float(v) for v in path[-1]],
                             waypoints=len(path), actions=actions,
                             end=bot.curr_pos_on_map, ms=move_ms,
                             plan_ms=plan_ms)
        # a short program through execute_code, from the start again
        bot.vlmaps_dataloader.from_full_map_pose(*start, 0.0)
        bot.set_agent_state(bot.vlmaps_dataloader.to_habitat_tf())
        bot.empty_recorded_actions()
        t0 = time.perf_counter()
        bot.execute_code(program(top, second))
        out["code"] = dict(actions=list(bot.get_recorded_actions()),
                           ms=1e3 * (time.perf_counter() - t0))
        bot._set_nav_curr_pose()
        out["code"]["end"] = bot.curr_pos_on_map
        out["heat"] = bot.get_map_3d(obj=second)
        if key == "card":
            nav = bot.nav
            t0 = time.perf_counter()
            graph = VisGraph(nav.obs_map)
            out["graph"] = (len(graph.nodes), graph.n_edges,
                            1e3 * (time.perf_counter() - t0), graph.core)
            # the fused goal pick of an object and a sound heat on the
            # card: nothing before the 12-byte fetch may wait for it
            obj = heatmap_from_mask_3d(
                bot.global_pc, labels == mp3dcat.index(top), cell_size=bot.cs,
                decay_rate=0.03, as_device=True, device="cuda")
            pts = [bot.vlmaps_dataloader.to_habitat_tf()[:3, 3]
                   + [0.4 * i, 0.0, -0.3 * i] for i in range(3)]
            snd_host = bot.get_distribution_map_3d(
                "sound", np.array([0.3, 1.0, 0.6], np.float32), pts, 0.05)
            snd = torch.from_numpy(snd_host).cuda()
            bot.get_max_pos_3d_fused(obj, snd)  # uploads grid_pos once
            torch.cuda.synchronize()
            fetch = dlv.fetch_np

            def fetch_after_pick(*arrays):
                torch.cuda.set_sync_debug_mode(0)
                return fetch(*arrays)

            dlv.fetch_np = fetch_after_pick
            torch.cuda.set_sync_debug_mode("error")
            try:
                picked = bot.get_max_pos_3d_fused(obj, snd)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                dlv.fetch_np = fetch
            host = obj.cpu().numpy() * snd_host
            out["pick"] = (picked, tuple(int(v) for v in
                                         bot.map.grid_pos[np.argmax(host)]))
        runs[key] = out
        del bot
    card, cpu = runs["card"], runs["host"]
    top = card["top"]
    nodes, edges, build_ms, core = card["graph"]
    print(f"  robot setup (load, K8 at C = {len(mp3dcat) + 1}, obstacles, "
          f"customised obstacles with K7, visgraph): card "
          f"{card['setup_s']:.1f} s, CPU {cpu['setup_s']:.1f} s; visgraph "
          f"({core}): {nodes} nodes, {edges} edges, built in "
          f"{build_ms:.1f} ms")
    second = card["second"]
    for name in (second, top, "far"):
        c, p = card[name], cpu[name]
        call = ("move_to(the free cell farthest from the start)"
                if name == "far" else f"move_to_object({name!r})")
        print(f"  {call} from {card['start']}: target {c['target']}, "
              f"reachable goal {c['goal']}; plan {c['plan_ms']:.2f} ms, "
              f"{c['waypoints']} waypoints; {len(c['actions'])} actions, "
              f"end {[round(v, 2) for v in c['end']]}, {c['ms']:.1f} ms on "
              f"the host clock (CPU robot: goal {p['goal']}, "
              f"{len(p['actions'])} actions)")
        checks[f"{call}: goal and actions card == CPU"] = \
            c["target"] == p["target"] and c["goal"] == p["goal"] \
            and c["actions"] == p["actions"]
        checks[f"{call}: last action 'stop', end within 3 cells of the "
               "goal"] = (
            c["actions"][-1] == "stop"
            and math.hypot(c["end"][0] - c["goal"][0],
                           c["end"][1] - c["goal"][1]) <= 3)
    for name in (second, top):
        checks[f"move_to_object({name!r}) moves"] = \
            len(card[name]["actions"]) > 1
    c, p = card["code"], cpu["code"]
    print(f"  execute_code({program(top, second)!r}): {len(c['actions'])} "
          f"actions, end {[round(v, 2) for v in c['end']]}, {c['ms']:.1f} ms "
          f"on the host clock (CPU robot: {len(p['actions'])} actions)")
    checks["execute_code: actions card == CPU, and the program moves"] = \
        c["actions"] == p["actions"] and len(c["actions"]) > 3
    s = np.sort(cpu["scores"], axis=1)
    clear = s[:, -1] - s[:, -2] > 1e-5 * np.abs(s[:, -1])
    checks["robot: K8 scores == CPU (atol 1e-4), labels on clear rows"] = (
        float(np.abs(card["scores"] - cpu["scores"]).max()) <= 1e-4
        and np.array_equal(np.argmax(card["scores"], 1)[clear],
                           np.argmax(cpu["scores"], 1)[clear]))
    checks[f"robot: get_map_3d(obj={second!r}) card == CPU (atol 1e-5), "
           "not empty"] = (
        float(np.abs(card["heat"] - cpu["heat"]).max()) <= 1e-5
        and float(card["heat"].max()) > 0)
    checks["robot: the native visgraph ran on both"] = \
        card["core"] == cpu["core"] == core == "native"
    picked, host = card["pick"]
    print(f"  get_max_pos_3d_fused(object {top!r} x sound) under "
          f"set_sync_debug_mode('error') up to the fetch: {picked}, host "
          f"argmax {host}")
    checks["fused goal pick: no host sync, == host argmax"] = picked == host

    # the port's CLIs in-process on the robot's scene
    out = tmp / "cli"
    out.mkdir()
    t0 = time.perf_counter()
    cli_index.main(["--data-dir", str(root), "--type", "object", "--query",
                    "chair", "--out", str(out / "heat.png"), "--device",
                    "cuda"])
    cli_obs.main(["--data-dir", str(root), "--out-prefix",
                  str(out / "obstacles"), "--device", "cuda"])
    written = sorted(p.name for p in out.iterdir())
    print(f"  CLIs index_map (object 'chair') and generate_obstacle_map: "
          f"{written} in {time.perf_counter() - t0:.1f} s")
    checks["CLIs wrote their images"] = written == [
        "heat.png", "obstacles_customized.png", "obstacles_raw.png"]
    for r in score_rows:
        r["slice9_launches"] = r.get("slice9_launches", 0) + \
            r["fn"].launches
    print(f"  K7/K8 launches in the phase: "
          f"{[(r['name'], r['fn'].launches) for r in score_rows]}; "
          f"{time.perf_counter() - t_phase:.1f} s wall")


# slice 11, recall parity at full width: write_synthetic_scene's bands on 8
# frames of 480^2, one LSeg window a frame, the medium mode's map (gs 128,
# cs 0.05, capacity 32,768) at 480^2 / 36 = 6,400 points a frame, batch 2
# (2 crops a forward, M = 1802)
S11_FRAMES = 8
S11_HW = 480
S11_RATE = 36
S11_BATCH = 2
# the bf16 row's gates.  A near tie: the oracle's top-1 margin below this
# many times the f32 row's largest |score d| (a bound that the bf16 map
# does not move).  The feature cosine mean's limit sits between the sound
# bf16 build (0.9999858; f32 0.9999941) and the planted faults of
# S11_FAULTS (0.9999643 and 0.9999134), all on an NVIDIA H100 80GB HBM3 at
# 700 W.  The min (sound 0.99895, f32 0.99898, the faults 0.99890 and
# 0.99889) moves with neither the precision nor those faults: its limit
# only catches a gross fault.
S11_TIE_FACTOR = 2.0
S11_COS_MEAN = 0.99997
S11_COS_MIN = 0.995
# the controls: planted faults of the bf16 ViT's kernels, each in block
# S11_FAULT_BLOCK of every forward (the other blocks and calls run as
# shipped); the smoke runs S11_FAULTS, probes/recall_phase.py any of them
S11_FAULT_BLOCK = LAYERS // 2


def _drop_mlp(k3, x2d, *args, **kw):
    return x2d  # the block's MLP term lost


def _no_softmax_scale(k2, *args, **kw):
    return k2(*args, **dict(kw, scale=1.0))  # logits 8x too large


def _lose_last_tile(k1, x2d, *args, **kw):
    out = k1(x2d, *args, **kw)
    out[-(x2d.shape[0] % 128 or 128):] = 0  # the rows past the last
    return out                              # full 128-row tile


PLANTED_FAULTS = {
    "K3 drops its MLP term": ("ln_mlp_residual", _drop_mlp),
    "K2 without its softmax scale": ("mha_oneshot_2d", _no_softmax_scale),
    "K1 loses its last partial row tile": ("ln_matmul", _lose_last_tile),
}
# the faults the bf16 gates must reject; the last one above moves the
# map's features too little for them (10 token rows of 1802 in one block)
S11_FAULTS = tuple(PLANTED_FAULTS)[:2]


@contextlib.contextmanager
def planted_fault(label: str, block: int = S11_FAULT_BLOCK):
    """One of ``PLANTED_FAULTS`` in the bf16 ViT: the kernel's call in
    block ``block`` of each forward goes through the fault."""
    from avlmaps_torch.models.lseg import vit

    name, fault = PLANTED_FAULTS[label]
    kernel, calls = getattr(vit, name), [0]

    def faulty(*args, **kw):
        i, calls[0] = calls[0], calls[0] + 1
        if i % LAYERS == block:
            return fault(kernel, *args, **kw)
        return kernel(*args, **kw)

    setattr(vit, name, faulty)
    try:
        yield
    finally:
        setattr(vit, name, kernel)


def _bf16_gates(report: dict, ties: dict) -> dict:
    return {f"feature cosine mean >= {S11_COS_MEAN}":
            report["feature_cos_mean"] >= S11_COS_MEAN,
            f"feature cosine min >= {S11_COS_MIN}":
            report["feature_cos_min"] >= S11_COS_MIN,
            "every disagreement a near tie": ties["not_near_ties"] == 0}


def recall_parity_run(tmp: Path, rows, checks: dict,
                      faults=S11_FAULTS) -> dict:
    """Slice 11: ``avlmaps_torch.tools.recall_parity`` at full width on
    the card.  The reference's network at ViT-L/16 width (seeded) builds
    the scene's map with the host-loop fusion in f32 (TF32 off); the
    port's ``LSegNet`` with the same weights builds it through
    ``VLMapBuilder``: in f32 (the plain blocks under ``full_f32``, K4),
    in bf16 (K1-K3 in every block, K4 in the fusion), and in bf16 with
    each of ``faults`` planted (:func:`planted_fault`).  Each port map is
    scored by K7 (held to its plain version on that map), the oracle's by
    numpy, and compared: voxel IoU >= 0.97 on the f32 and bf16 rows, f32 top-1
    agreement > 0.99; the bf16 row's feature cosine mean and min at
    least ``S11_COS_MEAN`` and ``S11_COS_MIN`` and every disagreement a
    near tie (margin below ``S11_TIE_FACTOR`` x the f32 row's largest
    |score d|); each planted fault of ``S11_FAULTS`` must fail those
    bf16 gates (any other is printed only).  K1-K4 and
    K7 are zeroed before and read after each row's path (K1-K3 96 times
    in the bf16 row, K4 4 times and K7 once in each); rows of ``rows``
    get ``slice11_launches``.  K4 at this build's shape: the bf16 build's
    first step (12,800 rows into 32,768 slots) against its plain version
    and K5 (:func:`shard_scatter_check`).  Then ``loc_eval`` on the card
    and on the CPU with the same SuperPoint weights: medians within
    1e-3 m.  Returns the printed numbers, with K4's row under
    ``scatter_row``."""
    import torch

    from avlmaps_torch.map import vlmap_builder as vb
    from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                                 SuperPointExtractor)
    from avlmaps_torch.ops.similarity import score_argmax_ref
    from avlmaps_torch.tools import loc_eval
    from avlmaps_torch.tools import recall_parity as rp

    t_phase = time.perf_counter()
    scene = rp.write_synthetic_scene(tmp / "slice11", n_frames=S11_FRAMES,
                                     h=S11_HW, w=S11_HW)
    mc, base2cam, base_tf = rp.map_config("medium", S11_HW, S11_HW)
    mc.depth_sample_rate = S11_RATE
    mc.max_pts_per_frame = S11_HW * S11_HW // S11_RATE
    landmarks = ["chair", "table", "sofa", "bed", "plant"]
    t0 = time.perf_counter()
    oracle, spec = rp.build_oracle("vitl16", seed=0)
    nets = {dt: rp.port_network(oracle, spec, "vitl16", "cuda", dt)
            for dt in (torch.bfloat16, torch.float32)}
    oracle.to("cuda")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opos, ofeat = rp.oracle_build_map(oracle, scene, mc, base2cam, base_tf,
                                      spec.out_dim, S11_BATCH, 0)
    oracle_s = time.perf_counter() - t0
    del oracle
    text = rp.landmark_text_features(landmarks, spec.out_dim,
                                     device="cuda")
    print(f"  set-up (ViT-L/16 oracle on the CPU, two port nets on the "
          f"card) {setup_s:.1f} s; the oracle's map: {len(opos)} voxels "
          f"in {oracle_s:.1f} s")
    counted = rows[:4] + [rows[5]]
    steps = S11_FRAMES // S11_BATCH
    numbers = {"card": card_line(), "setup_s": setup_s,
               "oracle_s": oracle_s, "voxels_oracle": int(len(opos))}
    tie_tol = None
    for i, (dt, label, planted) in enumerate((
            (torch.float32, "f32", None),
            (torch.bfloat16, "bf16", None),
            *((torch.bfloat16, f"bf16, {f}", planted_fault(f))
              for f in faults))):
        _zero(counted)
        t0 = time.perf_counter()
        with planted or contextlib.nullcontext(), \
                _FuseInputs(1, vb) as step1:
            m = rp.port_build_map(nets[dt], scene, mc, base2cam, base_tf,
                                  spec.out_dim, S11_BATCH, 0, "cuda",
                                  save_dir=tmp / f"slice11_map{i}")
            report, top1, otop1 = rp.score_and_compare(
                m.grid_pos, m.grid_feat, opos, ofeat, text, landmarks,
                "full-width-synthetic", "cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(counted)
        if tie_tol is None:  # the f32 row's
            tie_tol = S11_TIE_FACTOR * rp.near_ties(
                m.grid_pos, m.grid_feat, top1, opos, ofeat, otop1, text,
                0.0)["max_score_d"]
        ties = rp.near_ties(m.grid_pos, m.grid_feat, top1, opos, ofeat,
                            otop1, text, tie_tol)
        kernels = dt == torch.bfloat16
        row = dict(report, **ties, launches=counts, wall_s=wall)
        numbers[label] = row
        if planted:
            gates = _bf16_gates(report, ties)
            print(f"  {label} (block {S11_FAULT_BLOCK}): "
                  f"{json.dumps(report)}; disagreements "
                  f"{ties['disagreements']} ({ties['not_near_ties']} not "
                  f"near ties at {tie_tol:.3e}); the bf16 gates on it: "
                  f"{gates}")
            if label[len("bf16, "):] in S11_FAULTS:
                checks[f"the bf16 gates reject the planted fault: "
                       f"{label}"] = not all(gates.values())
            row["bf16_gates"] = gates
            continue
        want = {"ln_matmul": LAYERS * steps * kernels,
                "mha_oneshot_2d": LAYERS * steps * kernels,
                "ln_mlp_residual": LAYERS * steps * kernels,
                "sorted_segment_scatter_add_split": steps,
                "score_argmax": 1}
        checks[f"{label}: K1-K3 {want['ln_matmul']} times, K4 once a step, "
               "K7 once"] = counts == want
        if kernels:
            for r in counted:
                r["slice11_launches"] = r["fn"].launches
        with torch.no_grad():
            plain = score_argmax_ref(
                torch.from_numpy(m.grid_feat).cuda(),
                torch.from_numpy(text).cuda()).cpu().numpy()
        row["k7_equals_plain"] = k7_equal = bool(np.array_equal(plain, top1))
        print(f"  {label} row: {json.dumps(report)}; K7 top-1 equal to its "
              f"plain version on the map: {k7_equal}; disagreements "
              f"{ties['disagreements']} ({ties['near_ties']} near ties, "
              f"{ties['not_near_ties']} not, at a margin of "
              f"{tie_tol:.3e}; largest |score d| {ties['max_score_d']:.3e})"
              f"; launches {counts}; build + scoring {wall:.1f} s")
        checks[f"{label}: K7's top-1 equals its plain version"] = k7_equal
        checks[f"{label}: voxel IoU >= 0.97"] = report["voxel_iou"] >= 0.97
        if kernels:
            for name, ok in _bf16_gates(report, ties).items():
                checks[f"bf16: {name}"] = ok
            print(f"  K4 at this build's shape (gs {mc.gs}, capacity "
                  f"{mc.capacity}), the bf16 build's first step:")
            numbers["scatter_row"] = shard_scatter_check(
                "slice 11 bf16 step", step1.got, rows[3],
                launches=counts["sorted_segment_scatter_add_split"],
                **step1.shape)
        else:
            checks["f32: top-1 agreement > 0.99"] = \
                report["top1_agreement"] > 0.99
        del step1
    del nets
    torch.cuda.empty_cache()

    # loc_eval on the card and on the CPU, the same seeded SuperPoint
    cfg = SuperPointConfig(**loc_eval.SEEDED_SUPERPOINT)
    sp = SuperPointExtractor(cfg, device="cuda")
    sp_cpu = SuperPointExtractor(cfg, params={
        k: v.cpu() for k, v in sp.model.state_dict().items()}, device="cpu")
    t0 = time.perf_counter()
    card = loc_eval.evaluate_methods(sp, device="cuda")
    loc_s = time.perf_counter() - t0
    cpu = loc_eval.evaluate_methods(sp_cpu, device="cpu")
    for method in ("orb", "superpoint_mnn"):
        c, h = card[method], cpu[method]
        ok = (c["failures"] == h["failures"] == 0
              and abs(c["median_err_m"] - h["median_err_m"]) <= 1e-3)
        print(f"  loc_eval {method}: card median {c['median_err_m']:.6f} m,"
              f" mean {c['mean_err_m']:.6f}; CPU median "
              f"{h['median_err_m']:.6f}, mean {h['mean_err_m']:.6f}")
        checks[f"loc_eval {method}: card and CPU medians within 1e-3 m"] = \
            ok
    numbers["loc_eval"] = {"card": card, "cpu": cpu, "card_s": loc_s}
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"  slice 11 phase {numbers['phase_s']:.1f} s (loc_eval on the "
          f"card {loc_s:.1f} s); {numbers['card']}")
    return numbers


S12_MANIFESTS = {  # manifest -> (file name, port_checkpoints flag)
    "lseg_demo_e200": ("demo_e200.ckpt", "lseg"),
    "clip_vitb32": ("ViT-B-32.pt", "clip"),
    "audioclip_partial": ("AudioCLIP-Partial-Training.pt", "audioclip"),
    "superpoint_v1": ("superpoint_v1.pth", "superpoint"),
    "superglue_indoor": ("superglue_indoor.pth", "superglue"),
    "superglue_outdoor": ("superglue_outdoor.pth", "superglue"),
    "netvlad_pitts30k": ("Pitts30K_struct.mat", "netvlad"),
    "wav2clip_resnet18": ("wav2clip.pt", "wav2clip"),
}


def manifest_state_dict(manifest: dict, seed: int) -> dict:
    """A state dict shaped exactly as ``manifest`` says (dtypes too),
    drawn on the card (seconds for LSeg's 2 GB, where the numpy draw of
    ``ckpt_manifest.synthesize_state_dict`` takes tens): N(0, 0.05^2)
    floats, variances |.| + 0.5, integers 0."""
    import torch

    from avlmaps_torch.tools.ckpt_manifest import parse_spec

    dtypes = {np.float32: torch.float32, np.float16: torch.float16,
              np.int64: torch.int64, np.int32: torch.int32,
              np.uint8: torch.uint8, np.bool_: torch.bool}
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    sd = {}
    for k, spec in manifest["keys"].items():
        shape, dtype, _ = parse_spec(spec)
        if np.issubdtype(dtype, np.floating):
            t = torch.randn(shape, generator=g, device="cuda") * 0.05
            if k.endswith("running_var") or ".bn" in k and k.endswith("var"):
                t = t.abs() + 0.5
            sd[k] = t.to(dtypes[dtype]).cpu()
        else:
            sd[k] = torch.zeros(shape, dtype=dtypes[dtype])
    return sd


def write_manifest_files(root: Path) -> dict:
    """Every release artifact as a manifest-shaped file under ``root``:
    ``torch.save`` for ``.ckpt`` / ``.pt`` / ``.pth`` (LSeg's under
    ``state_dict``, as Lightning writes it), ``scipy.io.savemat`` of
    ``assemble_netvlad_mat`` for NetVLAD.  Returns manifest -> path."""
    import torch
    from scipy.io import savemat

    from avlmaps_torch.tools.ckpt_manifest import (assemble_netvlad_mat,
                                                   load_manifest)

    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (fname, _)) in enumerate(S12_MANIFESTS.items()):
        sd = manifest_state_dict(load_manifest(name), seed=20 + i)
        path = root / fname
        if name == "netvlad_pitts30k":
            savemat(str(path), assemble_netvlad_mat(
                {k: v.numpy() for k, v in sd.items()}))
        else:
            torch.save({"state_dict": sd} if name == "lseg_demo_e200"
                       else sd, path)
        paths[name] = path
        del sd
    return paths


def checkpoints_run(tmp: Path, checks: dict) -> dict:
    """Slice 12's checkpoints: the 8 manifest-shaped artifacts through
    ``port_checkpoints.main(... --strict-manifest --device cuda)``, each
    ``.pt`` (with its config) loaded onto the card into a module rebuilt
    from the files alone, and one bf16 LSeg forward of a 480^2 crop from
    the ported ``.pt`` bit for bit the forward from
    ``load_lseg_checkpoint`` of the same file.  Returns each artifact's
    port seconds."""
    import torch

    from avlmaps_torch.models.audioclip.audioclip import AudioClip
    from avlmaps_torch.models.audioclip import port as audioclip_port
    from avlmaps_torch.models.clip import port as clip_port
    from avlmaps_torch.models.clip.model import Clip
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference)
    from avlmaps_torch.models.lseg.port import load_lseg_checkpoint
    from avlmaps_torch.models.netvlad.model import NetVLAD, NetVLADConfig
    from avlmaps_torch.models.superglue.model import (SuperGlueConfig,
                                                      SuperGlueNet)
    from avlmaps_torch.models.superpoint.model import (SuperPointConfig,
                                                       SuperPointNet)
    from avlmaps_torch.models.wav2clip import Wav2Clip, Wav2ClipConfig
    from avlmaps_torch.tools import port_checkpoints

    t0 = time.perf_counter()
    paths = write_manifest_files(tmp / "release")
    write_s = time.perf_counter() - t0
    out = tmp / "ported"
    seconds = {}
    # one call with every flag (the indoor superglue), one for the outdoor
    for names in ([n for n in S12_MANIFESTS if n != "superglue_outdoor"],
                  ["superglue_outdoor"]):
        argv = ["--out", str(out), "--strict-manifest", "--device", "cuda"]
        for name in names:
            argv += [f"--{S12_MANIFESTS[name][1]}", str(paths[name])]
        for flag, r in port_checkpoints.main(argv).items():
            outdoor = names == ["superglue_outdoor"]
            seconds["superglue_outdoor" if outdoor else flag] = r["seconds"]

    def cfg_json(name):
        return json.loads((out / f"{name}.config.json").read_text())

    nv = cfg_json("netvlad")
    modules = {
        "lseg": lambda: LSegNet(LSegConfig.vitl16(), device="cuda"),
        "clip": lambda: Clip(clip_port.config_from_jsonable(
            cfg_json("clip")), device="cuda"),
        "audioclip": lambda: AudioClip(audioclip_port.config_from_jsonable(
            cfg_json("audioclip")), device="cuda"),
        "superpoint": lambda: SuperPointNet(SuperPointConfig(),
                                            device="cuda"),
        "superglue": lambda: SuperGlueNet(SuperGlueConfig(), device="cuda"),
        "superglue_outdoor": lambda: SuperGlueNet(SuperGlueConfig(),
                                                  device="cuda"),
        "wav2clip": lambda: Wav2Clip(Wav2ClipConfig(), device="cuda"),
        "netvlad": lambda: NetVLAD(NetVLADConfig(
            nv["clusters"], nv["dim"], nv["whiten_dim"]), device="cuda"),
    }
    loaded = {}
    for name, make in modules.items():
        m = make()
        m.load_state_dict(torch.load(out / f"{name}.pt"), strict=True)
        loaded[name] = sum(t.numel() for t in m.state_dict().values())
        del m
    checks["checkpoints: all 8 manifest-shaped artifacts ported with "
           "--strict-manifest and loaded on the card from their .pt"] = \
        len(seconds) == 8 and len(loaded) == 8

    cfg = LSegConfig.vitl16(torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    crop = torch.randn(1, 480, 480, 3, generator=g, device="cuda")
    feats = []
    for params in (torch.load(out / "lseg.pt"),
                   load_lseg_checkpoint(str(paths["lseg_demo_e200"]))):
        net = LSegNet(cfg, device="cuda")
        net.load_state_dict(params, strict=True)
        cast_params_for_inference(net)
        with torch.no_grad():
            feats.append(net.eval()(crop, upsample=False))
        del net, params
    same = torch.equal(*feats) and bool(torch.isfinite(
        feats[0].float()).all())
    checks["checkpoints: the bf16 LSeg forward from the ported lseg.pt "
           "equals load_lseg_checkpoint's, bit for bit"] = same
    print(f"  checkpoints: 8 manifest-shaped files written in {write_s:.1f} "
          f"s; port seconds (loader + strict load on the card): "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; parameters loaded from each .pt: {loaded}; the LSeg "
          f"forward from lseg.pt == load_lseg_checkpoint's: {same} "
          f"({tuple(feats[0].shape)})")
    del feats
    torch.cuda.empty_cache()
    return dict(write_s=write_s, port_s=seconds, loaded=loaded)


def slice12_run(tmp: Path, kernels, part_a: dict, checks: dict) -> dict:
    """Slice 12: the port's tools on the card.  Part A's row (the slice-10
    probe, held there); ``trace_step`` on the batch-8 sliding step (2
    warm, 3 traced: the categories sum to the total, K1-K3 24 launches a
    forward and K4 one a step); ``profile_step step step_dedup fusion
    lseg vit:fused``; ``ab_fusion_prep`` (every route held to
    ``index_add_``'s accumulator, K4 bitwise K5, inside the tool); the
    checkpoints (:func:`checkpoints_run`).  ``kernels`` (every kernel
    row) are zeroed first and get ``slice12_launches``."""
    import torch

    from avlmaps_torch.tools import ab_fusion_prep, profile_step, trace_step

    t_phase = time.perf_counter()
    out = {"card": card_line(), "part_a": {
        k: part_a.get(k) for k in ("output_d", "reversed_d", "first_call",
                                   "sequences_part_at", "dpt_ms",
                                   "dpt_ms_throughput",
                                   "crops_independent")}}
    print(f"  part A (slice 10's probe): output max |d| "
          f"{part_a['output_d']:.3e}, lseg.dpt {part_a['dpt_ms']:.4f} ms "
          f"(batch-8 taps), {part_a['dpt_ms_throughput']:.4f} ms "
          "(throughput shape)")
    _zero(kernels)
    k1k4 = kernels[:4]
    warm, reps = 2, 3
    path = trace_step.capture(tmp / "trace", reps, warm=warm)
    counts = _counts(k1k4)
    steps = warm + reps
    want = {"ln_matmul": LAYERS * steps, "mha_oneshot_2d": LAYERS * steps,
            "ln_mlp_residual": LAYERS * steps,
            "sorted_segment_scatter_add_split": steps}
    checks["trace: K1-K3 24 launches a forward, K4 one a step"] = \
        counts == want
    summ = trace_step.summarise(path, reps, per_op=True)
    checks["trace: the categories sum to the total"] = \
        sum(summ["category_ns"].values()) == summ["total_ns"] > 0
    checks["trace: 24 attn_wgmma_kernel and 1 segment_scatter_kernel "
           "launches a step in the trace"] = (
        summ["launches"]["port attn_wgmma_kernel"] == LAYERS
        and summ["launches"]["port segment_scatter_kernel"] == 1)
    out["trace"] = {k: summ[k] for k in ("total_ms", "categories",
                                         "launches", "ranges")}
    out["trace"]["wrapper_launches"] = counts
    print(f"  trace: {counts} over {steps} steps; {summ['total_ms']:.4f} "
          f"device ms a step; {out['card']}")
    print("  profile_step step step_dedup fusion lseg vit:fused:")
    out["profile"] = profile_step.main(["step", "step_dedup", "fusion",
                                        "lseg", "vit:fused"])
    print("  ab_fusion_prep:")
    out["ab_fusion_prep"] = ab_fusion_prep.run("cuda")
    torch.cuda.empty_cache()
    out["checkpoints"] = checkpoints_run(tmp / "ckpt", checks)
    for r in kernels:
        r["slice12_launches"] = r["fn"].launches
    out["launches"] = {r["name"]: r["slice12_launches"] for r in kernels}
    checks["slice 12: K1-K5 each launched on the phase's path"] = all(
        r["slice12_launches"] >= 1 for r in kernels[:4]
        + [r for r in kernels if r["name"] == "sorted_segment_scatter_add"])
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  slice 12 phase: {out['wall_s']:.1f} s wall; launches "
          f"{out['launches']}")
    return out


def ptxas_gate(logs) -> None:
    """Prints each kernel's registers and spill stores from ptxas, and
    ptxas's warnings; fails on a kernel that spills, or on warning C7508
    (setmaxnreg ignored: the wgmma consumers would lose their registers)."""
    from avlmaps_torch.kernels import build

    bad = []
    for name, log in logs.items():
        for fn, info in build.ptxas_report(log).items():
            if "kernel" not in fn or "registers" not in info:
                continue
            spill = info.get("spill_stores", 0)
            m = re.search(r"\d+([a-z_]+kernel)((?:I(?:L[^E]*E)+E)?)", fn)
            label = "".join(m.groups()) if m else fn[:60]
            print(f"  {name}: {label}: {info['registers']} registers, "
                  f"{spill} bytes spill stores")
            if spill:
                bad.append(f"{fn} spills {spill} bytes")
        for line in log.splitlines():
            if "warning" in line:
                print(f"  {name}: {line.strip()}")
            if "C7508" in line:
                bad.append(line.strip())
    if bad:
        raise AssertionError("ptxas: " + "; ".join(bad))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (REPO / "avlmaps_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from avlmaps_torch.kernels import build

    # a reference states and sets both (cuDNN defaults to TF32); the port
    # never switches either on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    ptxas_gate(logs)

    global GATE
    GATE = PositionGate()
    print("kernel checks (4 frames = 8 crops, M=7208; 31104 points):")
    rows = kernel_checks()
    print("score kernel checks (N=1e6, D=512, C=22 and 41):")
    rows += score_kernel_checks()
    print("slice 3 kernel checks (K6 at M=7208, K=4096, N=1024; K2 on "
          "(8, 16, 901, 64)):")
    vit_rows = vit_kernel_checks()
    from avlmaps_torch.ops import segment_scatter as ss

    k5_row = dict(name="sorted_segment_scatter_add",
                  fn=ss.sorted_segment_scatter_add, route="cuda",
                  source="avlmaps_torch/csrc/segment_scatter.cu",
                  replaces="avlmaps_tpu/ops/segment_scatter.py:358")
    with tempfile.TemporaryDirectory() as tmp:
        print("slice 1: ViT-L/16 bf16 map build, 720x1080, gs=1000 vh=30 "
              "cap=1e6:")
        scene, net, k4_step = slice_run(rows[:4], Path(tmp))
        print(f"K4 on a real batch-{BATCH} sliding step (the warm-up "
              "build's):")
        k4_real_check(k4_step, rows[3])
        del k4_step
        print("slice 3: throughput build, 64 packed 720x1080 frames, device "
              "sampling, whole canvas, batch 16:")
        captured, thr_t, thr_launches = throughput_run(net, Path(tmp),
                                                      k5_row, rows[:4])
        print(f"K1, K3 and K2 at the throughput build's shapes "
              f"(M={THR_BATCH * thr_t}; ({THR_BATCH}, {HEADS}, {thr_t}, "
              "64)):")
        thr_rows = throughput_shape_checks(thr_t, thr_launches)
        print("slice 3: K5 on a real batch-16 step (B=124,416, W=640, "
              "S=1e6+1):")
        k5_check(captured, k5_row)
        del captured
        print("slice 3: frame transport, sliding, batch 4, 2 steps:")
        frame_transport_run(net, Path(tmp), rows[3])
        print("slice 3: ViT routes, 8 crops of 480^2:")
        vit_routes_run(net, *vit_rows)
        print("slice 3: medium f32 LSeg on the card:")
        f32_lseg_check()
        print(f"slice 9: multi-floor build, {MF_FRAMES} 720x1080 frames on "
              f"two floors {MF_FLOOR_GAP:g} m apart, ViT-L/16 bf16, sliding, "
              f"batch {MF_BATCH}:")
        mf_scene, mf_rows, s9_checks = multi_floor_run(
            net, Path(tmp), rows, k5_row, vit_rows)
        print(f"slice 10: the row-sharded build: VLMapBuilder(mesh=) on the "
              f"slice-1 scene over the card and over {S10_SHARDS} virtual "
              f"shards of it, batch {S10_BATCH}; all_to_all; the "
              f"multi-floor build on {S10_SHARDS} shards; a warm sharded "
              "step:")
        s10_checks = {}
        s10 = sharded_build_run(net, scene, mf_scene, Path(tmp), rows,
                                k5_row, s10_checks)
        del net
        torch.cuda.empty_cache()
        print("slice 2: CLIP ViT-B/32 text tower, card vs CPU:")
        enc = clip_check()
        for r in rows:
            r["fn"].launches = 0
        print("slice 2: serving object query, 1e6 voxels x 512, "
              "1000x1000x30 grid, 22 categories, k=64:")
        serving_run(enc)
        print("slice 2: object query on the map slice 1 built:")
        object_query_run(enc, scene)
        for r in rows[4:]:
            r["launches"] = r["fn"].launches
        print("slice 7: area and sound maps on the slice-1 scene, "
              "AVLMap.load_map, area / sound / multimodal queries at "
              "gs=1000:")
        sound_area_run(enc, scene, rows[4:])
        print("slice 8: SuperPoint, SuperGlue, NetVLAD, the visual map and "
              "AVLMap.index_image, the multi-scale LSeg eval and Wav2CLIP "
              "on the slice-1 scene:")
        thr_rows += image_query_run(enc, scene, Path(tmp), rows[:3],
                                    rows[4:])
        print("slice 9: VLMapMultiFloor.index_map, HabitatLanguageRobot on "
              "the slice-1 map (card and CPU), the port's CLIs:")
        robot_run(enc, scene, mf_scene, Path(tmp), rows[4:], s9_checks)
        for name, ok in s9_checks.items():
            print(f"  {'pass' if ok else 'FAIL'}: {name}")
        if not all(s9_checks.values()):
            raise AssertionError("slice 9: the multi-floor or robot path "
                                 "failed")
        print(f"slice 10: index_map_sharded and sharded_score_argmax (K7 on "
              f"{S10_SHARDS} row shards):")
        s10["query"] = sharded_query_run(enc, scene, rows[5], s10_checks)
        for name, ok in s10_checks.items():
            print(f"  {'pass' if ok else 'FAIL'}: {name}")
        if not all(s10_checks.values()):
            raise AssertionError("slice 10: the sharded build or query "
                                 "failed")
        thr_rows += s10.pop("scatter_rows")
        print(json.dumps({"slice10": s10}))
        thr_rows += mf_rows
        print(f"slice 11: recall parity at full width, {S11_FRAMES} frames "
              f"of {S11_HW}^2, ViT-L/16 oracle (f32) against the port's "
              f"build in f32, in bf16 and in bf16 with each of "
              f"{len(S11_FAULTS)} planted faults, batch {S11_BATCH}; K4 at "
              "the build's shape; loc_eval on the card and the CPU:")
        s11_checks = {}
        s11 = recall_parity_run(Path(tmp), rows, s11_checks)
        for name, ok in s11_checks.items():
            print(f"  {'pass' if ok else 'FAIL'}: {name}")
        if not all(s11_checks.values()):
            raise AssertionError("slice 11: recall parity or loc_eval "
                                 "failed")
        thr_rows.append(s11.pop("scatter_row"))
        print(json.dumps({"slice11": s11}))
        print("slice 12: the port's tools on the card: trace_step (batch-8 "
              "sliding step), profile_step, ab_fusion_prep, port_checkpoints "
              "on the 8 manifest-shaped release artifacts:")
        s12_checks = {}
        s12 = slice12_run(Path(tmp), rows + [k5_row] + vit_rows,
                          s10["forward_batch_probe"], s12_checks)
        for name, ok in s12_checks.items():
            print(f"  {'pass' if ok else 'FAIL'}: {name}")
        if not all(s12_checks.values()):
            raise AssertionError("slice 12: the tools' phase failed")
        print(json.dumps({"slice12": s12}))
        for r in thr_rows:
            r["slice12_launches"] = s12["launches"].get(r["name"], 0)
    launches = {r["name"]: r["launches"] for r in rows[4:]}
    print(f"  slice 2 launches: {launches}")
    print(f"position gate: {GATE.n_builds} builds, {GATE.n_steps} fusion "
          "steps checked, every slot position inside the grid")
    if min(launches.values()) < 1:
        raise AssertionError("a kernel of the query path never launched")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = {"device_ms": "dev", "path": "path",
             "slice7_launches": "slice7_launches",
             "slice8_launches": "slice8_launches",
             "slice9_launches": "slice9_launches",
             "slice10_launches": "slice10_launches",
             "slice11_launches": "slice11_launches",
             "slice12_launches": "slice12_launches",
             "library_device_ms": "library_dev", "runs": "runs",
             "real_step": "real_step"}
    table = [{**{k: r[k] for k in keys},
              **{v: r[k] for k, v in extra.items() if k in r}}
             for r in rows + [k5_row] + vit_rows]
    print(json.dumps({"more_shapes": [
        {k: r[k] for k in ("shape", "device_ms", "library_device_ms",
                           "slice12_launches") + keys}
        for r in thr_rows]}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
