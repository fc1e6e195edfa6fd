"""Device ms a query under the port's ``query.image.superpoint`` range:
SuperPoint on the query image, with the copy of its
keypoints to the host."""


def read(view):
    ns = view.summary["under_ns"].get("query.image.superpoint", 0)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
