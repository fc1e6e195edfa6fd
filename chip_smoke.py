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
7. Prints the kernel table as one JSON line, then the card line, and last
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of every kernel ``fn`` launches, per call, from
    ``torch.profiler``: the kernels' own time, free of the host's launch
    gaps that bound ``time_ms`` near 0.1 ms for a call that launches two
    or more kernels (a wrapper's pass and GEMM, a library call's ops).
    Each kernel counts at its mean time per launch times its launches per
    call: after the build profiles, a later profile in the same process
    can miss some of a kernel's records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count * max(1, round(
        e.count / iters)) for e in prof.key_averages()
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


def run_lengths(slots) -> dict:
    """Run-length profile of a sorted batch: the runs of real slots, their
    mean and longest length, the rows in runs longer than 32 and 256, and
    the trash run's rows."""
    import torch

    vals, counts = torch.unique_consecutive(slots, return_counts=True)
    real = vals != CAPACITY
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
                    max_abs_err=err8, ms=time_ms(k8), plain_ms=time_ms(p8),
                    bound_ms=b8[0], bound_by=b8[1], library_ms=time_ms(lib8)),
               dict(name="score_argmax", fn=sim.score_argmax,
                    replaces="avlmaps_tpu/ops/similarity.py:157",
                    max_abs_err=bad, ms=time_ms(k7), plain_ms=time_ms(p7),
                    bound_ms=b7[0], bound_by=b7[1], library_ms=time_ms(lib7))]
        for r in got:
            r.update(route="cuda", source="avlmaps_torch/csrc/similarity.cu")
            print(f"  {r['name']} C={c}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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


PORT_KERNELS = ("wgmma_gemm_kernel", "ln_rows_kernel", "gelu_rows_kernel",
                "attn_wgmma_kernel", "segment_scatter_kernel")
# the port's record_function ranges on the build path; the profiler also
# lists each range among the device events (an annotation spanning its
# kernels), so device totals leave them out
BUILD_RANGES = ("build.", "lseg.")


class PositionGate:
    """After every build, every exported slot position lies inside the
    grid (0 <= row, col < gs, 0 <= h < vh) and is whole.  A slot whose
    position columns summed two voxels' positions -- two runs of equal
    slots merged into one -- reads past the grid, as a column of 1035 once
    did on the 1000-wide grid.

    Installed over the builder's ``fuse_points`` and ``_save``: each
    fusion step records on the card, with no host sync, how many used
    slots lie outside and the first of them; each save checks those
    records and the final state before the export, and fails with the
    step, the slot and its neighbours' positions."""

    def __init__(self):
        from avlmaps_torch.map import vlmap_builder as vb

        self.steps, self.record = [], True
        self.n_builds = self.n_steps = 0
        fuse, save = vb.fuse_points, vb.VLMapBuilder._save

        def fuse_checked(state, *args, **kw):
            out = fuse(state, *args, **kw)
            if self.record:
                self.steps.append(self.outside(out, kw["gs"], kw["vh"]))
            return out

        def save_checked(builder, state, gs, vh, mapped):
            self.check(state, gs, vh)
            return save(builder, state, gs, vh, mapped)

        vb.fuse_points = fuse_checked
        vb.VLMapBuilder._save = save_checked

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
    export's device->host copies, over the steps.  With ``attribute``,
    also prints the torch ops by the device time of the kernels they
    launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with GATE.paused(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        b.create_mobile_base_map(save_every=0, progress=False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(BUILD_RANGES)]
    step_ms = sum(e.self_device_time_total for e in kernels
                  if "DtoH" not in e.key) / 1e3 / steps
    print(f"  profiled {steps}-step build: device busy {step_ms:.3f} ms per "
          f"step (export copies excluded), {len(kernels)} kernel names; "
          "top by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    PATH_MS.clear()
    for e in kernels:
        name = next((k for k in PORT_KERNELS if k in e.key), None)
        if name is not None:
            print(f"    port kernel {name}: {e.count}x, "
                  f"{e.self_device_time_total / 1e3 / e.count:.4f} ms each "
                  f"({e.key[:60]})")
            PATH_MS[e.key] = e.self_device_time_total / 1e3 / e.count
    if attribute:
        attribute_ops(prof, steps)
    return step_ms


def attribute_ops(prof, steps: int, top: int = 16) -> None:
    """The torch ops that launch the build's kernels, by the device time
    of those kernels (device->host copies excluded), each with the port's
    ``build.*`` / ``lseg.*`` ranges around it, innermost first.  The port's
    own kernels go through ctypes and belong to no torch op."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    sites = {}
    for e in prof.events():
        if e.device_type != cpu:
            continue
        t = sum(k.duration for k in e.kernels if "DtoH" not in k.name)
        if t <= 0:
            continue
        ranges, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(BUILD_RANGES):
                ranges.append(p.name)
            p = p.cpu_parent
        key = (e.name, " < ".join(ranges) or "-")
        tt, n = sites.get(key, (0.0, 0))
        sites[key] = (tt + t, n + 1)
    by_range = {}
    for (_, rng), (t, _) in sites.items():
        by_range[rng] = by_range.get(rng, 0.0) + t
    total = sum(by_range.values()) / 1e3 / steps
    print(f"  torch ops' kernels: {total:.3f} ms per step; by range: "
          + ", ".join(f"{r} {t / 1e3 / steps:.3f}" for r, t in
                      sorted(by_range.items(), key=lambda kv: -kv[1])))
    print(f"  top {top} torch ops by their kernels' device time:")
    for (name, rng), (t, n) in sorted(sites.items(),
                                      key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / 1e3 / steps:8.3f} ms/step {n / steps:7.1f}x/step  "
              f"{name[:30]}  in {rng}")


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


def _sorted_step(captured):
    """A captured fusion step sorted into a fresh state, as fuse_points
    hands it to K4/K5."""
    from avlmaps_torch.ops import voxel_fusion as vf

    mc, _ = _map_setup()
    state = vf.init_fusion_state(mc.gs, mc.vh, FEAT, CAPACITY, device="cuda")
    return vf.sort_batch(state, *captured, gs=mc.gs, vh=mc.vh)


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
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
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
    cpu = ClipEncoder("ViT-B/32", device="cpu", params={
        k: v.cpu() for k, v in enc.model.state_dict().items()})
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
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
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
    acpu = AudioClipEncoder(aenc.cfg, device="cpu", params={
        k: v.cpu() for k, v in aenc.model.state_dict().items()})
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
    seen, hooks = [], []
    for m in (aenc.model.audio.conv1, aenc.model.audio.fc):
        s, h = _tf32_probe(m)
        seen.append(s)
        hooks.append(h)
    # TF32 on outside, as a user of the port has it by default: the
    # towers must switch it off for themselves
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = aenc.encode_audio_device(batch).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for h in hooks:
            h.remove()
    flags = [f for s in seen for f in s]
    print(f"  TF32 (cuDNN, cuBLAS) inside the audio tower: {set(flags)}")
    checks["TF32 off inside the audio forward, on outside"] = bool(
        flags) and not any(a or b for a, b in flags)
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
    vcpu = ClipEncoder("ViT-L/14", device="cpu", params={
        k: v.cpu() for k, v in venc.model.state_dict().items()})
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
             "library_device_ms": "library_dev", "runs": "runs",
             "real_step": "real_step"}
    table = [{**{k: r[k] for k in keys},
              **{v: r[k] for k, v in extra.items() if k in r}}
             for r in rows + [k5_row] + vit_rows]
    print(json.dumps({"more_shapes": [
        {k: r[k] for k in ("shape", "device_ms", "library_device_ms") + keys}
        for r in thr_rows]}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
