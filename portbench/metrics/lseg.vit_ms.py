"""Device ms a frame under the port's ``lseg.vit`` range."""


def read(view):
    ns = view.summary["under_ns"].get("lseg.vit", 0)
    frames = view.counts.get("frames")
    return ns / 1e6 / frames if ns and frames else None
