"""The least time the ViT's work needs (operations and bytes from its
widths, portbench/bench/roofline.py) over the device time under the
port's ``lseg.vit`` range."""

from portbench.bench import roofline


def read(view):
    ns = view.summary["under_ns"].get("lseg.vit", 0)
    crops, steps = view.counts.get("crops"), view.counts.get("steps")
    mod = view.cfg.get("module")
    if not ns or not crops or mod is None:
        return None
    per_forward = crops / steps
    least = crops * roofline.least_seconds(
        mod.vit_crop_flops(view.cfg), mod.vit_crop_bytes(view.cfg,
                                                         per_forward),
        view.cfg["encoder"]["dtype"])
    return 100.0 * least / (ns / 1e9)
