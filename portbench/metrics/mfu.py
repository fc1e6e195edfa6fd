"""The whole build's model operations a second, from the untraced
window's frames a second and the configuration's operations a frame,
over the card's peak rate for the configuration's dtype."""


def read(view):
    fps = view.window["metrics"].get("build_fps")
    mod = view.cfg.get("module")
    if not fps or mod is None or not hasattr(mod, "frame_flops"):
        return None
    return 100.0 * fps * mod.frame_flops(view.cfg) / mod.peak_flops(view.cfg)
