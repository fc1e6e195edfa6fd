"""The port's spans: the ``record_function`` ranges that name the host
work a card waits on, read from a Chrome trace of ``torch.profiler`` on
the CPU.  Each span opens once a build, a batch or a query, on the
calling thread, never once a frame."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avlmaps_torch.config import load_config
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.geometry.transforms import (build_base2cam_tf,
                                               build_base_transform)
from avlmaps_torch.map.area_map import AreaMap
from avlmaps_torch.map.vlmap_builder import VLMapBuilder
from avlmaps_torch.models.clip import ClipEncoder
from avlmaps_torch.models.lseg import LSegConfig, LSegNet
from avlmaps_torch.ops.delivery import make_text_object_query
from tools.recall_parity import write_synthetic_scene

H = W = 32
N_FRAMES = 5
BATCH = 2
N_BATCHES = -(-N_FRAMES // BATCH)


def _spans(prof, tmp_path):
    """Every ``record_function`` range of the trace: [(name, start,
    end, thread)]."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _counts(spans, prefixes):
    return Counter(n for n, *_ in spans if n.startswith(prefixes))


def _inside(spans, inner: str, outer: str) -> bool:
    outs = [s for s in spans if s[0] == outer]
    return all(any(o[1] <= s[1] and s[2] <= o[2] and o[3] == s[3]
                   for o in outs) for s in spans if s[0] == inner)


def _one_thread(spans, names) -> bool:
    return len({s[3] for s in spans if s[0] in names}) == 1


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_synthetic_scene(tmp_path_factory.mktemp("tracing"),
                                 n_frames=N_FRAMES, h=H, w=W)


def _builder(scene, out):
    mc = load_config().map_config
    mc.grid_size, mc.cell_size, mc.capacity = 64, 0.1, 16384
    mc.pose_info.camera_height = 0.8
    mc.depth_sample_rate, mc.max_pts_per_frame = 4, 256
    mc.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
    mc.lseg_base_size = mc.lseg_crop_size = W
    pi = mc.pose_info
    torch.manual_seed(0)
    net = LSegNet(LSegConfig.tiny16(), device="cpu")
    return VLMapBuilder(
        scene, mc, scene / "poses.txt",
        sorted((scene / "rgb").glob("*.png")),
        sorted((scene / "depth").glob("*.npy")),
        build_base2cam_tf(pi.base2cam_rot, pi.camera_height),
        build_base_transform(pi.base_forward_axis, pi.base_left_axis,
                             pi.base_up_axis),
        lseg_apply=lambda x: net(x, upsample=False),
        feat_dim=LSegConfig.tiny16().out_dim, batch_size=BATCH, seed=0,
        half_res_apply=True, device="cpu", map_save_dir=out)


def test_build_spans_once_a_batch(scene, tmp_path):
    b = _builder(scene, tmp_path / "vlmap")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = b.create_mobile_base_map(save_every=0, progress=False)
    assert b.build_stats["frames"] == N_FRAMES and m.num_occupied > 0
    spans = _spans(prof, tmp_path)
    got = _counts(spans, ("build.",))
    assert got["build.step"] == got["build.lseg"] == N_BATCHES
    assert got["build.wait_input"] == N_BATCHES + 1  # and the end marker
    for name in ("build.setup", "build.export", "build.save"):
        assert got[name] == 1, name
    assert N_BATCHES < N_FRAMES and N_FRAMES not in got.values()
    assert _inside(spans, "build.lseg", "build.step")
    assert _inside(spans, "build.fuse", "build.step")
    assert _one_thread(spans, set(got))
    # set-up ends before the first wait, the export before the save
    first = {n: min(s[1] for s in spans if s[0] == n) for n in got}
    last = {n: max(s[2] for s in spans if s[0] == n) for n in got}
    assert last["build.setup"] <= first["build.wait_input"]
    assert last["build.step"] <= first["build.export"]
    assert last["build.export"] <= first["build.save"]


def test_area_map_spans_once_a_batch(scene, tmp_path):
    torch.manual_seed(0)
    am = AreaMap(clip_encoder=ClipEncoder("tiny", device="cpu"),
                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        am.create_map(scene, batch_size=BATCH)
    assert am.clip_sparse_map.shape[0] == N_FRAMES
    spans = _spans(prof, tmp_path)
    got = _counts(spans, ("area.", "clip."))
    assert got == {"area.setup": 1, "area.read": N_BATCHES,
                   "clip.preprocess": N_BATCHES, "area.save": 1}
    assert _one_thread(spans, set(got))


def test_query_tokenize_span_once_a_query(rng, tmp_path):
    torch.manual_seed(0)
    enc = ClipEncoder("tiny", device="cpu")
    n, d, gs, vh = 256, enc.feat_dim, 16, 4
    feats = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    pos = torch.from_numpy(np.stack(
        [rng.integers(0, gs, n), rng.integers(0, gs, n),
         rng.integers(0, vh, n)], 1).astype(np.int32))
    other = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
    query = make_text_object_query(enc, (gs, gs, vh), k=4, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for word in ("chair", "table"):
            query(word, feats, pos, other)
    spans = _spans(prof, tmp_path)
    got = _counts(spans, ("query.tokenize", "query.text_encode"))
    assert got == {"query.tokenize": 2, "query.text_encode": 2}
    assert _inside(spans, "query.tokenize", "query.text_encode")
