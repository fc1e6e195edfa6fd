"""The build cell's there-and-back walk at tiny shapes: the sequence's
links, poses and pack, and the reference that runs LSeg once a rendered
frame."""

import os

import numpy as np
import pytest

import portbench.run as R
from portbench.bench import registry
from portbench.data import scene as scene_data
from portbench.reference import vlmap as ref_vlmap
from conftest import SEED, tiny_cell

CELL = "lseg-vitl16.build.packed"


def test_walk_order():
    assert scene_data.walk_order(4, 3).tolist() == [
        0, 1, 2, 3, 3, 2, 1, 0, 0, 1, 2, 3]
    assert scene_data.walk_order(3, 1).tolist() == [0, 1, 2]


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    wl, over = tiny_cell(CELL)
    ctx = R.context(wl, SEED, 0.3, "cpu", over,
                    tmp=tmp_path_factory.mktemp("tmp"))
    ctx.cache = tmp_path_factory.mktemp("cache")
    drv = registry.driver(wl["driver"])
    m = ctx.cfg["map"]
    canvas = ref_vlmap.plan_windows(*m["image_hw"], m["lseg_base_size"],
                                    m["lseg_crop_size"])[:2]
    return wl, ctx, drv.sequence(ctx, canvas), canvas


def test_cell_walks_three_passes():
    wl = registry.workload(CELL)
    assert wl["walk"] == {"passes": 3} and wl["scene"]["frames"] == 192
    assert len(scene_data.walk_order(192, 3)) == 576


def test_entries_link_their_source_frames(walk):
    wl, _, seq, _ = walk
    k = wl["scene"]["frames"]
    src = scene_data.walk_order(k, wl["walk"]["passes"])
    assert seq["src"].tolist() == src.tolist()
    assert len(seq["rgb"]) == len(seq["depth"]) == 3 * k
    frames = seq["frames"]
    for i, s in enumerate(src):
        for kind in ("rgb", "depth"):
            link = seq[kind][i]
            assert link.is_symlink()
            assert not os.path.isabs(os.readlink(link))
            assert link.resolve() == frames[kind][s].resolve()
    np.testing.assert_array_equal(seq["poses"], frames["poses"][src])


def test_pack_holds_every_entry(walk):
    from avlmaps_torch.pipeline.packed import PackedScene

    wl, ctx, seq, canvas = walk
    h, w = ctx.cfg["map"]["image_hw"]
    n = 3 * wl["scene"]["frames"]
    pack = PackedScene(seq["pack"])
    assert (pack.n, pack.h, pack.w) == (n, h, w)
    assert tuple(pack.canvas_hw) == tuple(canvas)
    assert pack.rgb.shape == (n, h, w, 3) and pack.rgb.dtype == np.uint8
    assert pack.depth.shape == (n, h, w) and pack.depth.dtype == np.uint16
    assert pack.canvas.shape == (n, *canvas, 3)
    per_frame = h * w * 3 + h * w * 2 + canvas[0] * canvas[1] * 3
    assert seq["pack"].stat().st_size >= n * per_frame
    rgb, _ = scene_data.load_frames(seq["frames"])
    for i in (0, n // 3 - 1, n // 3, n - 1):
        np.testing.assert_array_equal(pack.rgb[i], rgb[seq["src"][i]])
    assert scene_data.read_through(seq["pack"]) == seq["pack"].stat().st_size


def test_full_size_pack_reckoning():
    """A 720x1080 entry with its 347x520 canvas: 4.43 MB, so the
    576-entry pack is about 2.55 GB."""
    cfg = registry.config("lseg-vitl16")
    m = cfg["map"]
    h, w = m["image_hw"]
    ch, cw = ref_vlmap.plan_windows(h, w, m["lseg_base_size"],
                                    m["lseg_crop_size"])[:2]
    assert (ch, cw) == (347, 520)
    per = h * w * 3 + h * w * 2 + ch * cw * 3
    assert abs(per / 1e6 - 4.43) < 0.01
    assert abs(576 * per / 1e9 - 2.55) < 0.01


def test_reference_once_a_frame_equals_frame_by_frame(walk):
    """LSeg once a rendered frame, reused for its repeats, gives the map
    of the sequence computed entry by entry."""
    wl, ctx, seq, _ = walk
    cfg = ctx.cfg
    sd = cfg["module"].draw_lseg(cfg, 7, "cpu")
    spec = cfg["module"].reference_spec(cfg)
    rgb, depth = scene_data.load_frames(seq["frames"])
    src = seq["src"]
    args = (seq["poses"], cfg["map"], spec, sd, 7, cfg["map"]["batch_size"])
    once = ref_vlmap.build((rgb, depth), src, *args, device="cpu")
    each = ref_vlmap.build((rgb[src], depth[src]), np.arange(len(src)),
                           *args, device="cpu")
    np.testing.assert_array_equal(once["vid"], each["vid"])
    np.testing.assert_allclose(once["weight"], each["weight"], rtol=1e-6)
    np.testing.assert_allclose(once["feat"], each["feat"], rtol=1e-5,
                               atol=1e-6)
    assert np.abs(once["rgb"].astype(int) - each["rgb"]).max() <= 1
