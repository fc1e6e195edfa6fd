"""Profiling utilities (counterpart of ``avlmaps_tpu/utils/profiling.py``).

The reference's only instrumentation is a wall-clock ``Tic`` timer
(avlmaps/utils/time_utils.py:3-14); ``RateMeter`` is a throughput meter
for the builder loop.  Both time on the host clock; the port's spans are
``torch.profiler.record_function`` ranges, on the profiler's clock.
"""

from __future__ import annotations

import time
from typing import Optional


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
