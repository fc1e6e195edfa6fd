"""A/B of ``fuse_points``'s routes and its chain stages on the card.

Counterpart of ``tools/ab_fusion_prep.py``, at its geometry: B = 8 x
7776 rows a step on about B/9 voxels drawn in [300, 700)^2 x [0, vh) of
the 1000 x 1000 x 30 grid (the overlap of a batch's frames), 97% of the
rows valid, bf16 features (the encoder's output), D = 512, capacity 1e6.
It times

* ``fuse_points`` (``ops/voxel_fusion.py``) on each route: ``index_add_``
  (``dedup_scatter=False``), K5 on the assembled f32 rows with
  ``scatter_rle`` on and off (one kernel either way), and K4
  (``scatter_split``);
* the chain's stages alone: the slot gather, the stable argsort of a
  composite key, the payload gather, and the gather with the assembly of
  the f32 update.

Before any time is taken, each route's accumulator after one step from a
fresh state is held to ``index_add_``'s (|d| <= 1e-4 + 1e-5 x |x|) and
K4's bit for bit to K5's; a route that is not held raises.  The JAX
tool's ``block_rows`` variants size a TPU grid and have no counterpart
here (the CUDA kernels find their runs themselves).

    python -m avlmaps_torch.tools.ab_fusion_prep [--reps 6] [--device cuda]

Times are CUDA events on the card (the host clock with ``--device cpu``,
where every route is its plain version).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np
import torch

from avlmaps_torch.tools import trace_step as ts
from avlmaps_torch.tools.profile_step import timed

D = 512
ROUTES = {  # name -> fuse_points options
    "index_add_": dict(dedup_scatter=False),
    "K5 rle": dict(dedup_scatter=True, scatter_split=False,
                   scatter_rle=True),
    "K5 no rle": dict(dedup_scatter=True, scatter_split=False,
                      scatter_rle=False),
    "K4 split": dict(dedup_scatter=True, scatter_split=True),
}
ATOL, RTOL = 1e-4, 1e-5


def inputs(device, rows: Optional[int] = None, gs: int = ts.GS,
           vh: int = ts.VH, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX tool's batch: points on ~rows/9 voxels near the grid's
    centre, 97% valid, bf16 features."""
    b = rows or ts.BATCH * (ts.H * ts.W // ts.DEPTH_SAMPLE_RATE)
    rng = np.random.default_rng(seed)
    n_vox = max(b // 9, 1)
    lo, hi = int(0.3 * gs), int(0.7 * gs)
    centers = np.stack([rng.integers(lo, hi, n_vox),
                        rng.integers(lo, hi, n_vox),
                        rng.integers(0, vh, n_vox)], 1)
    pick = rng.integers(0, n_vox, b)
    vids = (centers[pick, 0] * gs * vh + centers[pick, 1] * vh
            + centers[pick, 2]).astype(np.int32)
    arrays = dict(vids=vids,
                  feats=rng.normal(size=(b, D)).astype(np.float32),
                  rgbs=rng.uniform(0, 255, (b, 3)).astype(np.float32),
                  alphas=rng.uniform(0.1, 1.0, b).astype(np.float32),
                  valid=rng.uniform(size=b) < 0.97)
    dv = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    dv["feats"] = dv["feats"].to(torch.bfloat16)
    return dv


def run(device="cuda", reps: int = 6, rows: Optional[int] = None,
        gs: int = ts.GS, capacity: int = ts.CAPACITY) -> Dict:
    """Holds every route, then times the routes and the stages; returns
    ``{"routes": {name: ms}, "stages": {name: ms}, "held": {name: max
    |d| against index_add_}}``."""
    from avlmaps_torch.ops.voxel_fusion import fuse_points, init_fusion_state
    from avlmaps_torch.utils.device import resolve_device

    dev = resolve_device(device)
    vh = ts.VH
    dv = inputs(dev, rows, gs, vh)
    b = dv["vids"].shape[0]

    def fresh():
        return init_fusion_state(gs, vh, D, capacity, device=dev)

    def fuse(opts) -> Callable:
        def step(state):
            return fuse_points(state, dv["vids"], dv["feats"], dv["rgbs"],
                               dv["alphas"], dv["valid"], gs=gs, vh=vh,
                               **opts)
        return step

    accums = {name: fuse(opts)(fresh()).accum for name, opts in
              ROUTES.items()}
    want = accums["index_add_"]
    held = {}
    for name, got in accums.items():
        d = (got - want).abs()
        held[name] = float(d.max())
        if not bool((d <= ATOL + RTOL * want.abs()).all()):
            raise AssertionError(
                f"fuse_points route {name}: accumulator {held[name]:.3e} "
                f"from index_add_'s, outside {ATOL:g} + {RTOL:g} x |x|")
    if not torch.equal(accums["K4 split"], accums["K5 rle"]):
        raise AssertionError("fuse_points: K4's accumulator is not K5's "
                             "bit for bit")
    del accums, want
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"rows={b}  voxels~{max(b // 9, 1)}  D={D}  capacity={capacity}; "
          "every route held to index_add_'s accumulator (|d| <= "
          f"{ATOL:g} + {RTOL:g} x |x|), K4 bitwise K5: "
          + ", ".join(f"{k} {v:.3e}" for k, v in held.items()), flush=True)

    routes = {}
    for name, opts in ROUTES.items():
        step = fuse(opts)
        step(fresh())  # warm, allocation path hot
        state = fresh()
        routes[name] = timed(lambda: step(state), dev, reps, warm=0)
        print(f"fuse_points {name:12s} {routes[name]:8.4f} ms/step "
              f"({clock})", flush=True)

    state = fuse(ROUTES["K4 split"])(fresh())
    occ = state.occupied_flat
    g = torch.Generator(device="cpu").manual_seed(1)
    key = torch.randint(0, gs * gs * vh, (b,), generator=g,
                        dtype=torch.int32).to(dev)
    perm = torch.randperm(b, generator=g).to(dev)
    w = dv["alphas"]
    stages = {
        "slot_gather": lambda: occ[dv["vids"].long()],
        "argsort": lambda: torch.argsort(key, stable=True),
        "payload_gather": lambda: dv["feats"][perm],
        "gather+assemble": lambda: torch.cat(
            [w[perm][:, None] * dv["feats"][perm].float(),
             torch.zeros((b, 128), dtype=torch.float32, device=dev)], 1),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = timed(fn, dev, reps, warm=1)
        print(f"stage {name:16s} {out[name]:8.4f} ms ({clock})", flush=True)
    return {"routes": routes, "stages": out, "held": held}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device, args.reps)


if __name__ == "__main__":
    main()
