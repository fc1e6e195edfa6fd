"""Profiling utilities (counterpart of ``avlmaps_tpu/utils/profiling.py``).

The reference's only instrumentation is a wall-clock ``Tic`` timer
(avlmaps/utils/time_utils.py:3-14); ``Profiler`` adds named scoped timers
with aggregate stats and ``RateMeter`` a throughput meter for the builder
loop.  All three time on the host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Tic:
    """Simple start/print timer (reference Tic)."""

    def __init__(self):
        self.t0 = time.time()

    def tic(self) -> None:
        self.t0 = time.time()

    def toc(self, label: str = "") -> float:
        dt = time.time() - self.t0
        print(f"{label} {dt:.4f}s" if label else f"{dt:.4f}s")
        return dt

    def print_time(self, label: str = "") -> float:
        return self.toc(label)


class Profiler:
    """Named scoped timers with aggregate stats."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} total {t:8.3f}s  calls {c:5d}  "
                         f"avg {t / c * 1e3:8.2f}ms")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class RateMeter:
    """Exponentially-smoothed items/sec meter for streaming loops."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def update(self, n_items: int = 1) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_items / max(now - self._last, 1e-9)
            self.rate = inst if self.rate is None else (
                self.alpha * inst + (1 - self.alpha) * self.rate)
        self._last = now
        return self.rate
