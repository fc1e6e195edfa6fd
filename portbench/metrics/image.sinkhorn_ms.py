"""Device ms a query under the port's ``query.image.sinkhorn`` range:
SuperGlue's 100-iteration log-domain Sinkhorn."""


def read(view):
    ns = view.summary["under_ns"].get("query.image.sinkhorn", 0)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
