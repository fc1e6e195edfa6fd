"""The least time of SuperGlue's Sinkhorn (one f32 read of the
(K0 + 1) x (K1 + 1) coupling a half-update and the write of Z, at the
card's bandwidth, portbench/bench/roofline.py) over the device time
under the port's ``query.image.sinkhorn`` range."""

from portbench.bench import roofline


def read(view):
    ns = view.summary["under_ns"].get("query.image.sinkhorn", 0)
    c, mod = view.counts, view.cfg.get("module")
    if not ns or not c.get("queries") or "K0" not in c or mod is None:
        return None
    nbytes = mod.sinkhorn_bytes(view.cfg, c["K0"], c["K1"])
    return 100.0 * c["queries"] * nbytes / roofline.PEAK_BYTES / (ns / 1e9)
