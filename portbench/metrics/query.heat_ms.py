"""Device ms a query of the EDT heat: the port's ``query.scatter_min``,
``query.edt_axis0-2`` and ``query.gather_heat`` ranges."""

RANGES = ("query.scatter_min", "query.edt_axis0", "query.edt_axis1",
          "query.edt_axis2", "query.gather_heat")


def read(view):
    u = view.summary["under_ns"]
    ns = sum(u.get(r, 0) for r in RANGES)
    n = view.counts.get("queries")
    return ns / 1e6 / n if ns and n else None
