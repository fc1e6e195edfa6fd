"""Device ms a query under the port's ``query.text_encode`` range."""


def read(view):
    ns = view.summary["under_ns"].get("query.text_encode", 0)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
