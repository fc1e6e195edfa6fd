"""Capture and summarise a profiler trace of the map-build step.

Counterpart of ``tools/trace_step.py``: it builds the same step as the
JAX tool's benchmark (the seeded ViT-L/16 LSeg in bf16, 720x1080 frames,
one point in 100 pixels: 7776 a frame, gs 1000, cs 0.05, vh 30, capacity
1e6), batch 8 in the sliding parity mode or, with ``--whole``, the
whole-canvas step at batch 16 (its 124,416 rows take K5), runs 3 warm
steps, traces ``--reps`` steps under ``torch.profiler`` (CPU and CUDA)
and exports a Chrome trace into ``--trace-dir``:

    python -m avlmaps_torch.tools.trace_step                # trace + summary
    python -m avlmaps_torch.tools.trace_step --per-op       # + top 24 ops
    python -m avlmaps_torch.tools.trace_step --whole --reps 3
    python -m avlmaps_torch.tools.trace_step --trace FILE   # summarise only

The summary reads the exported JSON (``--trace`` reads an existing one,
as the JAX tool's ``--xplane``): device time a step by category (each
port kernel by name, cuDNN convolution, library GEMM, sort and scan,
elementwise and reduce, copies and memsets, other) and by the port's
``build.*`` / ``lseg.*`` ranges.  The rules that count device time live
here and nowhere else (``chip_smoke.py`` imports them): the port's range
annotations, which the profiler lists among the device events, are left
out, and so are a build's device->host copies (its export) where a
build's time is summed.  Runs on the card unless ``--device cpu``; a
CPU trace has no device events, and its outermost torch ops stand in for
them.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the JAX tool's benchmark geometry (bench.py), kept here
H, W = 720, 1080
DEPTH_SAMPLE_RATE = 100
GS, CS, VH = 1000, 0.05, 30
CAPACITY = 1_000_000
BATCH = 8  # the sliding parity step
WHOLE_BATCH = 16  # the whole-canvas throughput step
WARM = 3

# the port's kernels, by the name each __global__ function has in a trace
PORT_KERNELS = ("wgmma_gemm_kernel", "ln_rows_kernel", "gelu_rows_kernel",
                "attn_wgmma_kernel", "segment_scatter_kernel", "score_kernel")
# the port's record_function ranges on the build path; the profiler also
# lists each range among the device events (an annotation spanning its
# kernels), so device totals leave them out
BUILD_RANGES = ("build.", "lseg.")
CATEGORIES = ("cuDNN convolution", "library GEMM", "sort and scan",
              "elementwise and reduce", "copies and memsets", "other")


def is_range(name: str) -> bool:
    """A port range's annotation, not device work."""
    return name.startswith(BUILD_RANGES)


def is_export_copy(name: str) -> bool:
    """A device->host copy: a build's export, left out of its step time."""
    return "DtoH" in name


def device_averages(prof) -> list:
    """``prof.key_averages()``'s device entries, the ranges left out."""
    dev = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if e.device_type == dev and not is_range(e.key)]


def build_device_ms(prof, steps: int) -> float:
    """A profiled build's device ms a step: every kernel and copy but
    the export's device->host copies."""
    return sum(e.self_device_time_total for e in device_averages(prof)
               if not is_export_copy(e.key)) / 1e3 / steps


def attribute_ops(prof, steps: int, top: int = 16) -> None:
    """The torch ops that launch a build's kernels, by the device time of
    those kernels (device->host copies excluded), each with the port's
    ``build.*`` / ``lseg.*`` ranges around it, innermost first.  The
    port's own kernels go through ctypes and belong to no torch op."""
    cpu = torch.autograd.DeviceType.CPU
    sites = {}
    for e in prof.events():
        if e.device_type != cpu:
            continue
        t = sum(k.duration for k in e.kernels if not is_export_copy(k.name))
        if t <= 0:
            continue
        ranges, p = [], e.cpu_parent
        while p is not None:
            if is_range(p.name):
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


def categorize(name: str) -> str:
    """The category of a device event by its kernel name."""
    port = next((k for k in PORT_KERNELS if k in name), None)
    if port is not None:
        return f"port {port}"
    low = name.lower()
    if name.startswith(("Memcpy", "Memset")):
        return "copies and memsets"
    if any(s in low for s in ("cudnn", "fprop", "dgrad", "wgrad", "conv_",
                              "_conv", "conv2d", "convolution", "convolve",
                              "nchwtonhwc", "nhwctonchw")):
        return "cuDNN convolution"
    if any(s in low for s in ("gemm", "gemv", "cublas", "cutlass",
                              "splitkreduce")):
        return "library GEMM"
    if "cub::" in name or any(s in low for s in ("sort", "scan")):
        return "sort and scan"
    if "at::native" in name:
        return "elementwise and reduce"
    return "other"


# ---------------------------------------------------------------- capture

def seeded_lseg(lseg: str = "vitl16", device="cuda", seed: int = 0):
    """The LSeg net of config ``lseg`` in bf16 with seeded weights, cast
    for inference (the benchmark's network)."""
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           init_params)
    from avlmaps_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = getattr(LSegConfig, lseg)(torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net = LSegNet(cfg, device=dev)
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    return net.eval().requires_grad_(False)


def calib(hw: Tuple[int, int]) -> np.ndarray:
    """The benchmark camera (f = cx = w/2, cy = h/2: 540, 540, 360 at
    720x1080)."""
    h, w = hw
    return np.array([[w / 2, 0, w / 2], [0, w / 2, h / 2], [0, 0, 1]],
                    np.float64)


def step_inputs(batch: int, hw: Tuple[int, int], device, seed: int = 0):
    """The step's inputs as the JAX tool draws them: a random uint8
    canvas, depth in [0.3, 5) m at the sampled pixels, random colours,
    identity poses, one pixel in 100 sampled a frame, every frame valid."""
    from avlmaps_torch.map.vlmap_builder import sample_pixels
    from avlmaps_torch.models.lseg.window import plan_windows

    h, w = hw
    mp = h * w // DEPTH_SAMPLE_RATE
    ch, cw, _, _, _ = plan_windows(h, w)
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, 255, (batch, ch, cw, 3)).astype(np.uint8),
              (rng.uniform(0.3, 5.0, (batch, mp)) * 1e3).astype(np.uint16),
              rng.integers(0, 255, (batch, mp, 3)).astype(np.uint8),
              np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1)),
              sample_pixels(rng, h, w, DEPTH_SAMPLE_RATE, mp, batch),
              np.ones((batch,), bool))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def build_step(whole: bool = False, device="cuda", lseg: str = "vitl16",
               hw: Tuple[int, int] = (H, W), gs: int = GS,
               capacity: int = CAPACITY, batch: Optional[int] = None,
               dedup_scatter: Optional[bool] = None, net=None):
    """``(run, net)``: ``run(n)`` takes ``n`` steps of the benchmark's
    map-build step (sliding at batch 8, or whole-canvas at batch 16) on
    one fusion state and waits for the card."""
    from avlmaps_torch.map.vlmap_builder import make_frame_step_canvas
    from avlmaps_torch.ops.voxel_fusion import init_fusion_state
    from avlmaps_torch.utils.device import resolve_device

    dev = resolve_device(device)
    net = net if net is not None else seeded_lseg(lseg, dev)
    b = batch or (WHOLE_BATCH if whole else BATCH)
    step = make_frame_step_canvas(
        lambda x: net(x, upsample=False), gs=gs, cs=CS, vh=VH,
        calib_mat=calib(hw), image_hw=hw, half_res_apply=True,
        lseg_eval="whole" if whole else "sliding",
        dedup_scatter=dedup_scatter, device=dev)
    state = init_fusion_state(gs, VH, net.cfg.out_dim, capacity, device=dev)
    args = step_inputs(b, hw, dev)

    def run(n: int) -> None:
        with torch.no_grad():
            for _ in range(n):
                step(state, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return run, net


def capture(trace_dir, reps: int, whole: bool = False, device="cuda",
            warm: int = WARM, **step_kw) -> Path:
    """Traces ``reps`` steps after ``warm`` warm ones; returns the Chrome
    trace written into ``trace_dir``.  ``step_kw`` go to
    :func:`build_step` (smaller shapes for a CPU run)."""
    from torch.profiler import ProfilerActivity, profile

    run, _ = build_step(whole, device, **step_kw)
    run(warm)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run(reps)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (f"step_{'whole' if whole else 'sliding'}_"
                  f"{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(str(path))
    print(f"trace: {path}")
    return path


# -------------------------------------------------------------- summarise

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _outermost(ops):
    """The ops no other op of the same thread encloses."""
    out = []
    by_tid = collections.defaultdict(list)
    for e in ops:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_tid.values():
        end = -1.0
        for e in sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0)
    return out


def summarise(trace, reps: int, per_op: bool = False) -> Dict:
    """The exported trace's device time a step (``reps`` steps traced), in
    integer nanoseconds summed exactly: ``total_ms``, ``categories``
    (ms), ``launches`` (events a step by category), ``ranges`` (ms by
    the port's ranges around each event's launch, innermost first, "-"
    for none) and ``ops`` (ms by name); prints them.  The device events
    are the kernels, copies and memsets (a CPU trace: its outermost torch
    ops), the port's range annotations and device->host copies left
    out."""
    events = [e for e in json.loads(Path(trace).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and not is_range(e["name"]) and not is_export_copy(e["name"])]
    device = "cuda"
    if not dev:
        device = "cpu"
        dev = _outermost([e for e in events if e.get("cat") == "cpu_op"])
    anchors = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in LAUNCH_CATS
               and "correlation" in e.get("args", {})}
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and is_range(e["name"]):
            ranges[(e.get("pid"), e.get("tid"))].append(e)

    def around(e) -> str:
        host = anchors.get(e.get("args", {}).get("correlation"), e)
        t = host["ts"]
        inside = sorted((r for r in ranges[(host.get("pid"), host.get("tid"))]
                         if r["ts"] <= t <= r["ts"] + r["dur"]),
                        key=lambda r: -r["ts"])
        return " < ".join(r["name"] for r in inside) or "-"

    cat_ns = collections.Counter()
    cat_n = collections.Counter()
    range_ns = collections.Counter()
    op_ns = collections.Counter()
    total_ns = 0
    for e in dev:
        ns = round(float(e.get("dur", 0)) * 1e3)
        total_ns += ns
        c = categorize(e["name"])
        cat_ns[c] += ns
        cat_n[c] += 1
        range_ns[around(e)] += ns
        op_ns[e["name"][:96]] += ns

    def ms(ns: int) -> float:
        return ns / reps / 1e6

    cats = [f"port {k}" for k in PORT_KERNELS] + list(CATEGORIES)
    cats += sorted(set(cat_ns) - set(cats))  # a kernel of a new name
    out = dict(device=device, reps=reps, total_ns=total_ns,
               total_ms=ms(total_ns),
               categories={c: ms(cat_ns[c]) for c in cats},
               category_ns={c: cat_ns[c] for c in cats},
               launches={c: cat_n[c] / reps for c in cats},
               ranges={r: ms(n) for r, n in range_ns.most_common()},
               ops={k: ms(n) for k, n in op_ns.most_common(24)})
    what = ("device time" if device == "cuda"
            else "CPU time of the outermost torch ops (no device events)")
    print(f"\n{what}: {out['total_ms']:.4f} ms a step over {reps} steps")
    for c in cats:
        print(f"  {ms(cat_ns[c]):9.4f} ms  {cat_n[c] / reps:8.1f} a step  {c}")
    print("by range:")
    for r, n in range_ns.most_common():
        print(f"  {ms(n):9.4f} ms  {r}")
    if per_op:
        print("top ops:")
        for k, v in out["ops"].items():
            print(f"  {v:9.4f} ms  {k}")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--trace-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "avlmaps_torch_trace"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--per-op", action="store_true")
    ap.add_argument("--trace", help="summarise an exported Chrome trace "
                                    "instead of capturing")
    ap.add_argument("--whole", action="store_true",
                    help="trace the whole-canvas step at batch 16 instead "
                         "of the sliding parity step at batch 8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    trace = args.trace or capture(args.trace_dir, args.reps, args.whole,
                                  args.device)
    return summarise(trace, args.reps, args.per_op)


if __name__ == "__main__":
    main()
