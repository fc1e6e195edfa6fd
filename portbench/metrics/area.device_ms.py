"""All device ms a frame of the traced area-map build."""


def read(view):
    ns = view.summary["device_ns"]
    frames = view.counts.get("frames")
    if not ns or not frames:
        return None
    return ns / 1e6 / frames
