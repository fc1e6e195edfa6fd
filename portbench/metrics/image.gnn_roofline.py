"""The least time SuperGlue's attentional network needs (operations and
bytes from the configuration's widths and the traced sets' sizes K0 and
K1, at the f32 peak, portbench/bench/roofline.py) over the device time
under the port's ``query.image.gnn`` range."""

from portbench.bench import roofline


def read(view):
    ns = view.summary["under_ns"].get("query.image.gnn", 0)
    c, mod = view.counts, view.cfg.get("module")
    if not ns or not c.get("queries") or "K0" not in c or mod is None:
        return None
    least = c["queries"] * roofline.least_seconds(
        mod.gnn_flops(view.cfg, c["K0"], c["K1"]),
        mod.gnn_bytes(view.cfg, c["K0"], c["K1"]),
        view.cfg["superglue"]["dtype"])
    return 100.0 * least / (ns / 1e9)
