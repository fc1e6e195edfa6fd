"""Run one benchmark cell of avlmaps_torch once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell (``portbench/workloads/<cell>.json``) and its
configuration, makes weights and data from ``--seed`` on the card, warms
up the cell's own shapes (all of that is ``setup_s``), runs the cell's
driver for ``--seconds``, and with ``--trace 1`` then profiles one more
segment for the per-layer metrics.  After the window the peak memory is
read, the program's state is let go, and what the window produced is
compared with the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), and last ``checks``, each
number compared beside its limit, which the last lines of standard error
repeat.  The line before it, on both streams, gives the bytes the
process wrote (``/proc/self/io``) and the bytes by which the run grew
the scene cache.  Exits 3 without a result when the cell's cards are
missing, 4 when a JAX module was loaded, 5 when the program is not in
the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import device as bdev  # noqa: E402
from portbench.bench import registry  # noqa: E402

bdev.prepare_environment(ROOT)
CACHE = ROOT / "portbench" / "_cache"
PROGRAM = "avlmaps_torch"


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def context(wl: dict, seed: int, seconds: float, device,
            cfg_override=None, tmp=None) -> SimpleNamespace:
    import torch

    cfg = registry.config(wl["config"])
    if cfg_override:
        module = cfg.pop("module")
        cfg = _merge(cfg, cfg_override)
        cfg["module"] = module
    base = Path(tmp or tempfile.gettempdir())
    return SimpleNamespace(
        workload=wl, cfg=cfg, seed=int(seed), seconds=float(seconds),
        device=torch.device(device),
        tmp=Path(tempfile.mkdtemp(prefix="portbench-", dir=base)),
        cache=CACHE)


def tree_bytes(root: Path) -> int:
    """Bytes of the files under ``root`` (links not followed)."""
    n = 0
    for d, _, files in os.walk(root):
        for f in files:
            try:
                n += os.lstat(os.path.join(d, f)).st_size
            except OSError:
                pass
    return n


def io_counts() -> dict:
    """This process's ``write_bytes`` and ``cancelled_write_bytes`` (what
    reached a block device) and ``wchar`` (what it handed to ``write``),
    its reaped children's included, or {} where the kernel does not say.
    A file system that is no block device (a host share) counts in
    ``wchar`` alone."""
    try:
        text = Path("/proc/self/io").read_text()
    except OSError:
        return {}
    pairs = dict(line.split(": ", 1) for line in text.splitlines()
                 if ": " in line)
    return {k: int(pairs[k]) for k in ("write_bytes",
                                        "cancelled_write_bytes", "wchar")
            if k in pairs}


def traced_segment(drv, st, ctx) -> dict:
    """The driver's traced segment under the profiler; its summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import counting

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(counting.WINDOW_SPAN):
            counts = drv.traced(st, ctx)
            _sync(ctx.device)
    path = ctx.tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    summary = counting.summarise(path)
    path.unlink()
    torch.cuda.empty_cache() if ctx.device.type == "cuda" else None
    return {"counts": counts, "summary": summary}


def per_layer(metrics: list, view: SimpleNamespace) -> dict:
    out = {}
    for m in metrics:
        v = registry.metric_reader(m["name"]).read(view)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(drv, st, ctx) -> dict:
    """Every number compared: name -> [value, limit]; a number printed
    beside them for information has the limit None."""
    nums = drv.numbers(drv.outputs(st, ctx), drv.reference(st, ctx), ctx, st)
    limits = ctx.workload.get("limits", {})
    return {k: [v, limits.get(k)] for k, v in nums.items()}


def run_cell(wl: dict, seed: int, seconds: float, trace: bool, device,
             man: dict, cfg_override=None, t_start: float = None) -> dict:
    """One run of cell ``wl``; returns the result line as a dict."""
    import torch

    t_start = T_START if t_start is None else t_start
    ctx = context(wl, seed, seconds, device, cfg_override)
    dev = ctx.device
    drv = registry.driver(wl["driver"])
    bdev.full_f32()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    chosen = registry.cell_metrics(man, wl["name"])
    try:
        with torch.no_grad():
            st = drv.setup(ctx)
            _sync(dev)
            setup_s = time.perf_counter() - t_start
            t0 = time.perf_counter()
            res = drv.window(st, ctx)
            _sync(dev)
            t1 = time.perf_counter()
            seg = traced_segment(drv, st, ctx) if trace else None
            t2 = time.perf_counter()
            record = bdev.device_record(dev, wl["chips"])
            if seg is not None:
                s = seg["summary"]
                record["busy_s"] = s["busy_ns"] / 1e9
                record["window_s"] = s["window_ns"] / 1e9
            drv.free(st)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            checks = judge(drv, st, ctx)
            print(f"portbench: setup {setup_s:.2f} s, window {t1 - t0:.2f} "
                  f"s, traced segment {t2 - t1:.2f} s, check "
                  f"{time.perf_counter() - t2:.2f} s", file=sys.stderr)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    limited = [(v, lim) for v, lim in checks.values() if lim is not None]
    correct = bool(limited) and all(
        math.isfinite(v) and v <= lim for v, lim in limited)
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"]}
    if not trace:
        vals = dict(res["metrics"], setup_s=setup_s)
        line["metrics"] = {m["name"]: {"value": vals[m["name"]],
                                       "unit": m["unit"]}
                           for m in chosen["end_to_end"]
                           if m["name"] in vals}
    else:
        view = SimpleNamespace(summary=seg["summary"], counts=seg["counts"],
                               window=res, cfg=ctx.cfg, workload=wl)
        line["metrics"] = per_layer(chosen["per_layer"], view)
    line["device"] = record
    if trace:
        s = seg["summary"]
        line["breakdown"] = {
            "device_ops": [[k, v / 1e9] for k, v in s["top_ops"][:10]],
            "idle_gaps": [[k, v / 1e9] for k, v in s["idle"][:10]]}
    line["checks"] = checks  # last: each number compared, with its limit
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = registry.manifest()
    if args.workload not in {w["name"] for w in man["workloads"]}:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program {PROGRAM!r} is not in the checkout; "
              "no result", file=sys.stderr)
        return 5
    wl = registry.workload(args.workload)
    bdev.require_cards(wl["chips"])
    cache_before = tree_bytes(CACHE)
    line = run_cell(wl, args.seed, args.seconds, bool(args.trace), "cuda",
                    man)
    found = bdev.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded: {found}; no result",
              file=sys.stderr)
        return 4
    io = dict(io_counts(),
              scene_cache_created_bytes=tree_bytes(CACHE) - cache_before)
    print(f"portbench io: {json.dumps(io)}", flush=True)
    print(f"portbench io: {json.dumps(io)}", file=sys.stderr)
    for name, (v, lim) in line["checks"].items():
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
