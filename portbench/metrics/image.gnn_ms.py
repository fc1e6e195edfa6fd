"""Device ms a query under the port's ``query.image.gnn`` range:
SuperGlue's keypoint encoder, its 18 attentional layers, the
final projection and the scores."""


def read(view):
    ns = view.summary["under_ns"].get("query.image.gnn", 0)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
