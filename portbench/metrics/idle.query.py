"""Share of the traced queries' time in which no operation ran on the
card."""


def read(view):
    s = view.summary
    if "queries" not in view.counts or not s["busy_ns"]:
        return None
    return 100.0 * (1.0 - s["busy_ns"] / s["window_ns"])
