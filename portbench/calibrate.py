"""Readings for a cell's limits: the numbers compared, for the program
on many seeds and for the control (the reference in the precision below
the configuration's, put in the program's place) on some, in one
process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 3 [--out FILE]

Prints one JSON line per seed: the window's end-to-end numbers, the
program's numbers and, for a control seed, the control's.  The
benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import portbench.run as R  # noqa: E402
from portbench.bench import device as bdev  # noqa: E402
from portbench.bench import registry  # noqa: E402


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    wl = registry.workload(args.workload)
    bdev.require_cards(wl["chips"])
    bdev.full_f32()
    drv = registry.driver(wl["driver"])
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = R.context(wl, seed, args.seconds, "cuda")
        with torch.no_grad():
            st = drv.setup(ctx)
            res = drv.window(st, ctx)
            drv.free(st)
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = drv.reference(st, ctx)
            t2 = time.perf_counter()
            rec = {"seed": seed, "metrics": res["metrics"],
                   "program": drv.numbers(drv.outputs(st, ctx), ref, ctx,
                                          st),
                   "reference_s": t2 - t1, "setup_and_window_s": t1 - t0}
            if seed in ctl_seeds:
                low = drv.reference(st, ctx, drv.CONTROL)
                rec["control"] = drv.numbers(low, ref, ctx, st)
                rec["control_precision"] = drv.CONTROL
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        shutil.rmtree(ctx.tmp, ignore_errors=True)
        del st, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
