"""Device ms a query of K7: the events under the port's
``query.score_argmax`` range and the ``score_kernel`` launches that carry
no range (ctypes launches)."""

from portbench.trace import counting


def read(view):
    s = view.summary
    ns = s["under_ns"].get("query.score_argmax", 0) \
        + counting.named(s, "score_kernel", "unranged_ns")
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
