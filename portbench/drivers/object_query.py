"""The serving object query in a closed loop with one client: ask for an
object, wait for the goal and the top k on the host, ask again.

Set-up: the CLIP text tower's weights and the served map from the seed
(``data/query_map.py``, prototypes from the reference's text features),
the resident categories encoded once by the port (as
``init_categories`` does), and one query per category word as warm-up.
The entry is the closure of ``ops.delivery.make_text_object_query``; a
query's latency runs from the call until its goal and top k are host
arrays.  A sample of the window's queries, drawn from the seed as they
complete (reservoir sampling), and the last keep their device heat for
the check.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench.data import query_map
from portbench.reference import clip as ref_clip
from portbench.reference import object_query as ref_q
from portbench.reference.precision import Precision

TEMPLATES = json.loads((Path(__file__).resolve().parent.parent / "reference"
                        / "templates.json").read_text())
CONTROL = "tf32"  # the precision below the text tower's f32


def setup(ctx):
    from avlmaps_torch.ops.delivery import make_text_object_query

    cfg, wl = ctx.cfg, ctx.workload
    text = cfg["text"]
    words = list(cfg["categories"])
    sd = cfg["module"].draw_clip(text, ctx.seed, ctx.device)
    protos = ref_clip.template_features(sd, words, TEMPLATES, text["heads"],
                                        Precision("f32"))
    m = query_map.make_map(wl, words, protos, ctx.seed, ctx.device)
    enc = cfg["module"].clip_encoder(text, sd, ctx.device)
    resident = enc.get_text_feats_multiple_templates(words, as_device=True)
    others = {w: resident[[i for i, v in enumerate(words) if v != w]]
              for w in words}
    query = make_text_object_query(
        enc, tuple(wl["grid"]), cell_size=cfg["map"]["cell_size"],
        decay_rate=wl["decay_rate"], k=wl["k"], with_topk=True,
        device=ctx.device)
    # every seed asks for each word once in each run of len(words)
    # queries, in its own order: the same work, other arrivals
    rng = np.random.default_rng(ctx.seed)
    order = np.concatenate([rng.permutation(len(words))
                            for _ in range(1 << 10)])
    st = SimpleNamespace(sd=sd, enc=enc, query=query, others=others,
                         feats=m["feat"], pos=m["pos"], words=words,
                         order=order, rng=rng, kept=[])
    for w in words:  # every shape the window runs
        _ask(st, w)
    return st


def _ask(st, word: str):
    from avlmaps_torch.ops.delivery import fetch_np

    out = st.query(word, st.feats, st.pos, st.others[word])
    t_enq = time.perf_counter()
    goal, vals, pos = fetch_np(out["goal_pos"], out["topk_vals"],
                               out["topk_pos"])
    return out, t_enq, (goal, vals, pos)


def window(st, ctx) -> dict:
    lat, enq = [], []
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        word = st.words[int(st.order[n % len(st.order)])]
        ts = time.perf_counter()
        with record_function("bench.query"):
            out, t_enq, host = _ask(st, word)
        te = time.perf_counter()
        lat.append(te - ts)
        enq.append(t_enq - ts)
        _sample(st, n, ctx.workload["checked_queries"] - 1,
                (word, out["heat"], host))
        last = (word, out["heat"], host)
        n += 1
        if te - t0 >= ctx.seconds:
            break
    wall = te - t0
    st.kept.append(last)
    return {"metrics": {"query_p95_ms": float(np.percentile(lat, 95) * 1e3),
                        "query_qps": n / wall},
            "attempted": n, "failed": 0,
            "counts": {"queries": n, "wall_s": wall,
                       "enqueue_ms": float(np.mean(enq) * 1e3)}}


def _sample(st, n: int, size: int, item) -> None:
    """A uniform sample of ``size`` of the queries so far, drawn from the
    seed (reservoir sampling); the others' heats are let go."""
    if n < size:
        st.kept.append(item)
        return
    j = int(st.rng.integers(0, n + 1))
    if j < size:
        st.kept[j] = item


def traced(st, ctx) -> dict:
    n = 50
    for i in range(n):
        with record_function("bench.query"):
            _ask(st, st.words[int(st.order[-1 - i])])
    return {"queries": n}


def free(st) -> None:
    st.enc = st.query = st.others = None


def outputs(st, ctx) -> list:
    return [{"word": w, "heat": h, "goal_pos": g, "topk_vals": v,
             "topk_pos": p} for w, h, (g, v, p) in st.kept]


def reference(st, ctx, precision: str = "f32") -> list:
    """The reference's answer to each checked query, with its margins;
    in a lower precision, the control's answer."""
    cfg, wl = ctx.cfg, ctx.workload
    p = Precision(precision)
    words = st.words
    text = ref_clip.template_features(st.sd, words, TEMPLATES,
                                      cfg["text"]["heads"], p)
    cos = ref_q.cosines(st.feats, text, p)
    pos = st.pos.long()
    dpc = wl["decay_rate"] / cfg["map"]["cell_size"]
    out, cache = [], {}
    for item in outputs(st, ctx):
        w = item["word"]
        if w not in cache:
            mg = ref_q.margins(cos, words.index(w))
            h = ref_q.heat(pos, mg >= 0, wl["grid"], dpc)
            cache[w] = dict(ref_q.delivery(h, pos, wl["k"]), heat=h,
                            margin=mg, word=w)
        out.append(cache[w])
    st.ref_dims = (wl["grid"], dpc, wl["k"], pos)
    return out


def numbers(got: list, ref: list, ctx, st) -> dict:
    """``mask_gap``: the largest |reference margin| of a voxel the
    answer assigns otherwise than the reference (margins up to the
    ``mask_gap`` limit count as ties, where either side is the
    reference's too); ``heat_gap``: the largest gap of the answer's
    heat, goal heat and top k from the reference's heat of that mask."""
    dims, dpc, k, pos = st.ref_dims
    tie = ctx.workload.get("limits", {}).get("mask_gap", 0.0)
    mask_gap = heat_gap = 0.0
    for g, r in zip(got, ref):
        gh = g["heat"].to(r["heat"].device).float()
        gmask = gh == 1.0
        rmask = r["margin"] >= 0
        dis = gmask != rmask
        if bool(dis.any()):
            mask_gap = max(mask_gap, float(r["margin"][dis].abs().max()))
        judged = torch.where(r["margin"].abs() <= tie, gmask, rmask)
        h = r["heat"] if bool((judged == rmask).all()) else \
            ref_q.heat(pos, judged, dims, dpc)
        goal, ok_g = _rows(pos, g["goal_pos"], dims)
        at, ok_k = _rows(pos, g["topk_pos"], dims)
        if not (ok_g and ok_k):
            heat_gap = max(heat_gap, 1.0)  # an answer that is no voxel
            continue
        tk = _tensor(g["topk_vals"], h.device).float()
        best = torch.sort(h, descending=True, stable=True).values[:k]
        heat_gap = max(heat_gap, float((gh - h).abs().max()),
                       float(h.max() - h[goal].max()),
                       float((tk - h[at]).abs().max()),
                       float((tk - best).abs().max()))
    return {"mask_gap": mask_gap, "heat_gap": heat_gap}


def _tensor(x, dev) -> torch.Tensor:
    """A host array's or a tensor's values on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _rows(pos: torch.Tensor, cells, dims):
    """(rows of ``pos`` at ``cells``, whether every cell is a voxel)."""
    c = _tensor(cells, pos.device).long().reshape(-1, 3)
    _, y, z = dims
    lin = (pos[:, 0] * y + pos[:, 1]) * z + pos[:, 2]
    order = torch.argsort(lin)
    want = (c[:, 0] * y + c[:, 1]) * z + c[:, 2]
    i = torch.searchsorted(lin[order], want).clamp(max=lin.shape[0] - 1)
    return order[i], bool((lin[order][i] == want).all())
