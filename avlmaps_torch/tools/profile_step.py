"""Per-segment timings of the map-build step on the card.

Counterpart of ``tools/profile_step.py``, at the same geometry (the
benchmark's: :mod:`avlmaps_torch.tools.trace_step`), each segment timed
with CUDA events over 6 calls after 2 warm ones:

    python -m avlmaps_torch.tools.profile_step step fusion lseg vit:fused
    python -m avlmaps_torch.tools.profile_step vit        # every attn_impl

Segments:
  step        the sliding step at batch 8 with ``dedup_scatter=False``
              (``index_add_``), as the JAX tool's ``step``
  step_dedup  the same with the dedup scatter (K4; K5 past its rows)
  fusion      ``fuse_points`` alone: 8 x 7776 rows into capacity 1e6
  lseg        the LSeg forward, ``upsample=False``, 16 crops of 480^2
  vit[:impl]  the ViT backbone alone on the 16 crops, for each of the
              port's ``DenseViTConfig.attn_impl`` values (or the one
              named), with its model FLOP utilisation

The utilisation counts the dense products and attention the port really
computes a crop: T = 901 tokens (1 + 30^2, no padding; the JAX tool
counts its padded flash shape), 24 blocks of width D = 1024:
24 x T x 2 x D x 12 D for the products and 24 x 4 x T^2 x D for QK^T and
PV, against the card's dense bf16 peak (989e12 FLOP/s, NVIDIA's H100 SXM
figure), printed beside the card's name and power limit.  Runs on the
card unless ``--device cpu`` (host-clock ms then, and no utilisation).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from avlmaps_torch.tools import trace_step as ts

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
ATTN_IMPLS = ("fused", "flash", "splash", "xla")
SEGMENTS = ("step", "step_dedup", "fusion", "lseg", "vit")
T, D, LAYERS = 901, 1024, 24
CROPS = 2 * ts.BATCH


def vit_flops(crops: int, t: int = T, d: int = D,
              layers: int = LAYERS) -> float:
    """The ViT's dense products and attention on ``crops`` crops."""
    return crops * layers * (t * 2 * d * 12 * d + 4 * t * t * d)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timed(fn: Callable, device, reps: int = 6, warm: int = 2) -> float:
    """ms a call of ``fn``: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(warm):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fusion_inputs(device, gs: int = ts.GS, rows: Optional[int] = None,
                  d: int = 512, seed: int = 0):
    """The JAX tool's ``fusion`` inputs: random voxel ids over the grid,
    normal f32 features, every row valid."""
    b = rows or ts.BATCH * (ts.H * ts.W // ts.DEPTH_SAMPLE_RATE)
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, gs * gs * ts.VH, b).astype(np.int32),
              rng.normal(size=(b, d)).astype(np.float32),
              rng.uniform(0, 255, (b, 3)).astype(np.float32),
              rng.uniform(0.1, 1, b).astype(np.float32),
              np.ones(b, bool))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def fusion_segment(device, gs: int = ts.GS, capacity: int = ts.CAPACITY,
                   rows: Optional[int] = None, reps: int = 6,
                   warm: int = 2):
    """``(ms, state)``: ``fuse_points`` alone on one state, the same
    batch every call."""
    from avlmaps_torch.ops.voxel_fusion import fuse_points, init_fusion_state

    vids, feats, rgbs, alphas, valid = fusion_inputs(device, gs, rows)
    state = init_fusion_state(gs, ts.VH, feats.shape[1], capacity,
                              device=device)

    def run():
        fuse_points(state, vids, feats, rgbs, alphas, valid, gs=gs,
                    vh=ts.VH)

    return timed(run, device, reps, warm), state


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("segments", nargs="*",
                    help=f"any of {', '.join(SEGMENTS)}, vit:<impl>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from avlmaps_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    segs = set(args.segments) or set(SEGMENTS)
    impls = [a.split(":", 1)[1] for a in segs if a.startswith("vit:")]
    unknown = {a for a in segs if a not in SEGMENTS
               and not a.startswith("vit:")} | set(impls) - set(ATTN_IMPLS)
    if unknown:
        ap.error(f"unknown segments {sorted(unknown)}")
    cuda = dev.type == "cuda"
    clock = "CUDA events" if cuda else "host clock, CPU"
    if cuda:
        print(card_line())
    out: Dict[str, float] = {}

    def report(label: str, ms: float, flops: Optional[float] = None,
               extra: str = "") -> None:
        out[label] = ms
        mfu = ""
        if flops and cuda:
            out[f"{label}_mfu"] = flops / (ms * 1e-3) / PEAK_BF16
            mfu = f"  mfu={out[f'{label}_mfu']:.3f}"
        print(f"{label:12s} {ms:9.3f} ms ({clock}){mfu}{extra}", flush=True)

    net = None
    if segs & {"step", "step_dedup", "lseg"} or impls or "vit" in segs:
        net = ts.seeded_lseg("vitl16", dev)
    for name in ("step", "step_dedup"):
        if name in segs:
            run, _ = ts.build_step(device=dev, net=net,
                                   dedup_scatter=name == "step_dedup")
            ms = timed(lambda: run(1), dev)
            report(name, ms, extra=f"  (fps={ts.BATCH / (ms * 1e-3):.1f})")
            del run
    if "fusion" in segs:
        report("fusion", fusion_segment(dev)[0])
    x = None
    if net is not None and (segs & {"lseg", "vit"} or impls):
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(CROPS, 480, 480, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        if "lseg" in segs:
            report("lseg", timed(lambda: net(x, upsample=False), dev))
        if impls or "vit" in segs:
            from avlmaps_torch.models.lseg import cast_params_for_inference
            from avlmaps_torch.models.lseg.vit import DenseViT

            for impl in impls or ATTN_IMPLS:
                with torch.device(dev):
                    vit = DenseViT(dataclasses.replace(net.cfg.vit,
                                                       attn_impl=impl))
                cast_params_for_inference(vit)
                vit.load_state_dict(net.backbone.state_dict(), strict=True)
                vit.eval().requires_grad_(False)
                report(f"vit_{impl}", timed(lambda: vit(x), dev),
                       flops=vit_flops(CROPS))
                del vit
    if cuda:
        print(card_line())
    return out


if __name__ == "__main__":
    main()
