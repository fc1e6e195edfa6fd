"""Device ms a query under the port's ``query.image.retrieve`` range:
the CLIP encode of the query image and its product with the
frames' cached descriptors."""


def read(view):
    ns = view.summary["under_ns"].get("query.image.retrieve", 0)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
