"""Device ms a frame under the port's ``lseg.dpt`` and ``lseg.head``
ranges."""


def read(view):
    u = view.summary["under_ns"]
    ns = u.get("lseg.dpt", 0) + u.get("lseg.head", 0)
    frames = view.counts.get("frames")
    return ns / 1e6 / frames if ns and frames else None
