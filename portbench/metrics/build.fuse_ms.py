"""Device ms a frame under the port's ``build.fuse`` range (the voxel
fusion and K4)."""


def read(view):
    ns = view.summary["under_ns"].get("build.fuse", 0)
    frames = view.counts.get("frames")
    return ns / 1e6 / frames if ns and frames else None
