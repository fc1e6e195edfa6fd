"""Device time from a Chrome trace of ``torch.profiler``: a frozen copy of
the port's ``tools/trace_step`` rules, extended to the whole traced
segment.

- The device events are the kernels, copies and memsets.  The range
  annotations the profiler also lists on the device are not device work.
- An event belongs to every ``record_function`` range that was open on
  the launching host thread when it was launched (found through the
  launch's correlation id); a range's device time is the sum of its
  events'.  The port's own kernels go through ctypes, and some (K7's
  ``score_kernel``) carry no runtime launch event: find those by name.
- Busy time is the union of the device events' intervals inside the
  traced window (the harness's ``bench.trace_window`` span); the idle
  gaps are its complement there, each named by what the host's main
  thread was doing at the gap's middle: the innermost range and the
  innermost torch op open there.
- Times are summed in integer nanoseconds.
"""

from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.trace_window"
# the port's ranges and the harness's own ranges around its calls
RANGE_PREFIXES = ("build.", "lseg.", "query.", "bench.", "area.")


def is_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIXES)


def _ns(us) -> int:
    return round(float(us) * 1e3)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarise(trace_path) -> Dict:
    """The traced segment's numbers: ``window_ns``, ``busy_ns``,
    ``device_ns`` (all device events), ``under_ns`` (by range, every
    enclosing range counted), ``unranged_ns`` (by name, the events with
    no range or no launch record), ``kernel_ns`` (by name), ``idle``
    ([label, ns] by what the host did, longest first) and ``top_ops``
    ([name, ns], longest first).  Only events inside the traced window count."""
    events = [e for e in json.loads(Path(trace_path).read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"{trace_path}: no {WINDOW_SPAN} span")
    win = windows[0]
    w0, w1 = _ns(win["ts"]), _ns(win["ts"]) + _ns(win["dur"])
    main = (win.get("pid"), win.get("tid"))

    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and not is_range(e.get("name", ""))]
    anchors = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in LAUNCH_CATS
               and "correlation" in e.get("args", {})}
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and is_range(e["name"]):
            ranges[(e.get("pid"), e.get("tid"))].append(e)

    def enclosing(e) -> List[str]:
        host = anchors.get(e.get("args", {}).get("correlation"))
        if host is None:
            return []
        t = host["ts"]
        inside = [r for r in ranges[(host.get("pid"), host.get("tid"))]
                  if r["ts"] <= t <= r["ts"] + r["dur"]]
        return [r["name"] for r in sorted(inside, key=lambda r: -r["ts"])]

    under = collections.Counter()
    unranged = collections.Counter()
    kernels = collections.Counter()
    intervals = []
    total = 0
    for e in dev:
        s = _ns(e["ts"])
        d = _ns(e.get("dur", 0))
        if s < w0 or s >= w1:
            continue
        total += d
        intervals.append((s, min(s + d, w1)))
        names = set(enclosing(e))
        for name in names:
            under[name] += d
        if not names:
            unranged[e["name"][:120]] += d
        kernels[e["name"][:120]] += d
    busy = _merge(intervals)
    busy_ns = sum(e - s for s, e in busy)

    # idle gaps inside the window, named by the main thread's work: the
    # innermost range (few) and the innermost torch op (recent ones)
    own = [e for e in events if (e.get("pid"), e.get("tid")) == main
           and e is not win]
    annots = [(_ns(e["ts"]), _ns(e["ts"]) + _ns(e.get("dur", 0)), e["name"])
              for e in own if e.get("cat") == "user_annotation"]
    ops = sorted((_ns(e["ts"]), _ns(e["ts"]) + _ns(e.get("dur", 0)),
                  e["name"]) for e in own if e.get("cat") == "cpu_op")
    op_starts = [o[0] for o in ops]

    def innermost(cands, t: int):
        best = None
        for s, e, name in cands:
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else None

    def label(t: int) -> str:
        i = bisect.bisect_right(op_starts, t)
        parts = [p for p in (innermost(annots, t),
                             innermost(ops[max(0, i - 256):i], t)) if p]
        return " / ".join(parts) if parts else "host (no torch op)"

    idle = collections.Counter()
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            idle[label((prev + s) // 2)] += s - prev
        prev = max(prev, e)
    return {
        "window_ns": w1 - w0, "busy_ns": busy_ns, "device_ns": total,
        "under_ns": dict(under), "unranged_ns": dict(unranged),
        "kernel_ns": dict(kernels),
        "idle": [[k, v] for k, v in idle.most_common()],
        "top_ops": [[k, v] for k, v in kernels.most_common()],
    }


def named(summary: Dict, part: str, key: str = "kernel_ns") -> int:
    """Device ns of the events whose name holds ``part`` (``key``:
    ``"unranged_ns"`` for those launched outside every range)."""
    return sum(v for k, v in summary[key].items() if part in k)
