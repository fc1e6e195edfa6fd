"""Idle device time put down to the host work that the card waited on.

``counting.summarise`` names each idle gap of the traced segment by what
the main thread was doing at its middle: ``"<range>"`` or
``"<range> / <torch op>"``, the innermost ``record_function`` range of any
name and the innermost torch op open there.  A reader of idle under the
program's own spans sums the gaps whose range is one of them.
"""

from __future__ import annotations

from typing import Dict, Iterable


def idle_ns(summary: Dict, spans: Iterable[str]) -> int:
    """Idle ns of the gaps whose innermost range is one of ``spans``,
    over the summary's whole list of gaps."""
    spans = set(spans)
    return sum(ns for label, ns in summary["idle"]
               if label.split(" / ", 1)[0] in spans)


def per_count_ms(view, spans: Iterable[str], count: str):
    """Idle ms under ``spans`` for each of the traced segment's ``count``
    (``"frames"``, ``"queries"``): 0.0 where no gap falls under them,
    None where the segment did not count ``count``."""
    n = view.counts.get(count)
    if not n:
        return None
    return idle_ns(view.summary, spans) / 1e6 / n
