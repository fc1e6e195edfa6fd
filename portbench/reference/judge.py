"""The numbers that decide ``correct``: each compares what the timed path
produced with the reference, one gap per number, each held to a limit
in the cell's driver."""

from __future__ import annotations

from typing import Dict

import numpy as np


def port_map(grid_pos: np.ndarray, weight: np.ndarray, feat: np.ndarray,
             rgb: np.ndarray, gs: int, vh: int) -> Dict[str, np.ndarray]:
    """A built map's arrays keyed and sorted by voxel id."""
    gp = grid_pos.astype(np.int64)
    vid = gp[:, 0] * gs * vh + gp[:, 1] * vh + gp[:, 2]
    order = np.argsort(vid, kind="stable")
    return {"vid": vid[order], "weight": weight[order],
            "feat": feat[order], "rgb": rgb[order]}


def map_gaps(got: Dict[str, np.ndarray],
             ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``voxels``: voxels in one map only, over the reference's count;
    ``weight``: summed |weight difference| (a voxel of one map only
    counts whole) over the reference's total; ``feature``: the
    weight-averaged relative L2 gap of the features of shared voxels;
    ``colour``: mean |colour difference| of shared voxels over 255;
    ``map_gap``: the largest of the four."""
    if len(got["vid"]) != len(np.unique(got["vid"])):
        return {"voxels": 1.0, "weight": 1.0, "feature": 1.0,
                "colour": 1.0, "map_gap": 1.0}
    common, gi, ri = np.intersect1d(got["vid"], ref["vid"],
                                    return_indices=True)
    n_ref = max(len(ref["vid"]), 1)
    voxels = (len(got["vid"]) + len(ref["vid"]) - 2 * len(common)) / n_ref
    wg = got["weight"].astype(np.float64)
    wr = ref["weight"].astype(np.float64)
    only = wg.sum() - wg[gi].sum() + wr.sum() - wr[ri].sum()
    weight = (np.abs(wg[gi] - wr[ri]).sum() + only) / max(wr.sum(), 1e-30)
    if len(common):
        fg = got["feat"][gi].astype(np.float64)
        fr = ref["feat"][ri].astype(np.float64)
        w = wr[ri]
        feature = float((w * np.linalg.norm(fg - fr, axis=1)).sum()
                        / max((w * np.linalg.norm(fr, axis=1)).sum(), 1e-30))
        colour = float(np.abs(got["rgb"][gi].astype(np.float64)
                              - ref["rgb"][ri]).mean() / 255.0)
    else:
        feature = colour = 1.0
    out = {"voxels": float(voxels), "weight": float(weight),
           "feature": feature, "colour": colour}
    out["map_gap"] = max(out.values())
    return out


def feature_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest relative L2 gap between rows (frames' features)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    num = np.linalg.norm(got - ref, axis=1)
    den = np.maximum(np.linalg.norm(ref, axis=1), 1e-30)
    return float(np.max(num / den)) if len(ref) else 0.0
