"""Planner optimality harness for the port's visibility-graph planner.

Counterpart of ``tools/planner_eval.py``.  Quantifies the raster
visibility-graph planner (``avlmaps_torch/nav/visgraph.py``, in place of
the reference's pyvisgraph stack,
avlmaps/utils/navigation_utils.py:77-197) against a dense 8-connected
grid-Dijkstra oracle on randomised obstacle maps:

* optimality ratio = visgraph path length / grid-oracle path length.
  The oracle disallows corner cutting, so its length bounds the true
  Euclidean shortest path from above: an any-angle planner lands at
  ratio <= 1.0 (it cuts the oracle's 8-direction staircase) and never
  far above it;
* feasibility: every path leg re-checked against the raster with the
  planner's own clearance test;
* build / plan wall clock, and a pyvisgraph comparison when that package
  is importable.

The port's ``VisGraph`` has no ``use_internal_contours`` option (it
always takes the full contour hierarchy, which the JAX tool's default
``internal=True`` asks for), so ``evaluate`` takes no ``internal``.
Host only:

    python -m avlmaps_torch.tools.planner_eval [--maps 20 --size 160 --seed 0]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np

from avlmaps_torch.nav.visgraph import VisGraph, line_clear


def random_obstacle_map(rng: np.random.Generator, size: int = 160,
                        n_rect: int = 6, n_disc: int = 4,
                        hollow: bool = False) -> np.ndarray:
    """Random obstacle raster (1 free, 0 blocked): axis-aligned rectangles
    and discs, bordered; ``hollow=True`` adds a room with interior free
    space (an internal contour, the reference's escape-logic case)."""
    m = np.ones((size, size), np.uint8)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 0
    for _ in range(n_rect):
        h = int(rng.integers(size // 16, size // 4))
        w = int(rng.integers(size // 16, size // 4))
        r = int(rng.integers(1, size - h - 1))
        c = int(rng.integers(1, size - w - 1))
        m[r:r + h, c:c + w] = 0
    rr, cc = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for _ in range(n_disc):
        rad = int(rng.integers(size // 20, size // 8))
        r = int(rng.integers(rad + 1, size - rad - 1))
        c = int(rng.integers(rad + 1, size - rad - 1))
        m[(rr - r) ** 2 + (cc - c) ** 2 <= rad * rad] = 0
    if hollow:
        # a walled room (internal contour) with a free interior and no door
        r0, c0 = size // 3, size // 3
        r1, c1 = r0 + size // 4, c0 + size // 4
        m[r0:r1, c0:c1] = 0
        m[r0 + 2:r1 - 2, c0 + 2:c1 - 2] = 1
    return m


def grid_shortest_length(obs_map: np.ndarray, start: Tuple[int, int],
                         goal: Tuple[int, int]) -> float:
    """Dense 8-connected Dijkstra oracle over free cells (no corner
    cutting): an upper bound on the true Euclidean shortest path length."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    free = obs_map != 0
    h, w = free.shape
    idx = -np.ones((h, w), np.int64)
    idx[free] = np.arange(int(free.sum()))
    rows_i, cols_i, data = [], [], []
    moves = [(0, 1, 1.0), (1, 0, 1.0), (1, 1, np.sqrt(2)),
             (1, -1, np.sqrt(2))]
    fr, fc = np.where(free)
    for dr, dc, cost in moves:
        nr, nc = fr + dr, fc + dc
        ok = (nr >= 0) & (nr < h) & (nc >= 0) & (nc < w)
        ok[ok] &= free[nr[ok], nc[ok]]
        if cost > 1.0:  # diagonal: both orthogonal neighbours must be free
            o = ok.copy()
            o[ok] &= (free[fr[ok] + dr, fc[ok]] & free[fr[ok], fc[ok] + dc])
            ok = o
        rows_i.append(idx[fr[ok], fc[ok]])
        cols_i.append(idx[nr[ok], nc[ok]])
        data.append(np.full(int(ok.sum()), cost))
    n = int(free.sum())
    g = coo_matrix((np.concatenate(data),
                    (np.concatenate(rows_i), np.concatenate(cols_i))),
                   shape=(n, n))
    s, t = idx[start[0], start[1]], idx[goal[0], goal[1]]
    if s < 0 or t < 0:
        return np.inf
    dist = dijkstra(g.tocsr(), directed=False, indices=s)
    return float(dist[t])


def path_length(path: List[List[float]]) -> float:
    p = np.asarray(path, np.float64)
    return float(np.sum(np.hypot(*np.diff(p, axis=0).T)))


def path_is_clear(obs_map: np.ndarray, path: List[List[float]]) -> bool:
    blocked = obs_map == 0
    return all(line_clear(blocked, a, b)
               for a, b in zip(path[:-1], path[1:]))


def _sample_free_pair(rng, obs_map, min_sep: float):
    free_r, free_c = np.where(obs_map != 0)
    for _ in range(100):
        i, j = rng.integers(0, free_r.size, 2)
        s = (int(free_r[i]), int(free_c[i]))
        g = (int(free_r[j]), int(free_c[j]))
        if np.hypot(s[0] - g[0], s[1] - g[1]) >= min_sep:
            return s, g
    return None, None


def evaluate(n_maps: int = 20, size: int = 160, seed: int = 0,
             queries_per_map: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    ratios, build_ts, plan_ts, infeasible = [], [], [], 0
    pyvis_ts: Optional[list] = None
    try:
        import pyvisgraph  # noqa: F401

        pyvis_ts = []
    except ImportError:
        pass
    n_q = 0
    for mi in range(n_maps):
        m = random_obstacle_map(rng, size=size, hollow=(mi % 3 == 0))
        t0 = time.perf_counter()
        g = VisGraph(m)
        build_ts.append(time.perf_counter() - t0)
        for _ in range(queries_per_map):
            s, t = _sample_free_pair(rng, m, min_sep=size * 0.4)
            if s is None:
                continue
            oracle = grid_shortest_length(m, s, t)
            if not np.isfinite(oracle):
                continue  # disconnected pair: the oracle reaches neither
            t0 = time.perf_counter()
            path = g.shortest_path(s, t)
            plan_ts.append(time.perf_counter() - t0)
            n_q += 1
            if not path_is_clear(m, path):
                infeasible += 1
                continue
            ratios.append(path_length(path) / oracle)
    return {
        "n_maps": n_maps, "size": size, "queries": n_q,
        "feasible": len(ratios), "infeasible": infeasible,
        "ratio_mean": float(np.mean(ratios)) if ratios else np.nan,
        "ratio_p95": float(np.percentile(ratios, 95)) if ratios else np.nan,
        "ratio_max": float(np.max(ratios)) if ratios else np.nan,
        "build_ms_mean": 1e3 * float(np.mean(build_ts)),
        "plan_ms_mean": 1e3 * float(np.mean(plan_ts)),
        "pyvisgraph": "not importable" if pyvis_ts is None else pyvis_ts,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--maps", type=int, default=20)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    r = evaluate(n_maps=args.maps, size=args.size, seed=args.seed)
    print("| maps | queries | feasible | mean ratio | p95 | max | "
          "build ms | plan ms |")
    print("|---|---|---|---|---|---|---|---|")
    print(f"| {r['n_maps']} ({r['size']}^2) | {r['queries']} | "
          f"{r['feasible']}/{r['queries']} | {r['ratio_mean']:.4f} | "
          f"{r['ratio_p95']:.4f} | {r['ratio_max']:.4f} | "
          f"{r['build_ms_mean']:.1f} | {r['plan_ms_mean']:.1f} |")
    if r["infeasible"]:
        print(f"INFEASIBLE PATHS: {r['infeasible']}")
    print(f"pyvisgraph: {r['pyvisgraph']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
