"""The port's headless UI cores against the JAX package's: the
interactive map (avlmaps_torch/map/interactive_map.py) on the nav scene
of tests/test_nav_robot.py, the 3D visualisation fallbacks and palettes
(avlmaps_torch/utils/visualize.py) and the category assigner
(avlmaps_torch/utils/category_assigner.py).  Everything here is host
numpy and OpenCV, so the outputs are equal."""

import numpy as np
import pytest

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map.interactive_map import InteractiveMap as JaxImap
from avlmaps_tpu.robot.sim import KinematicSimulator as JaxSim
from avlmaps_tpu.utils import category_assigner as jca
from avlmaps_tpu.utils import visualize as jvis
from avlmaps_torch.config import load_config
from avlmaps_torch.map.interactive_map import InteractiveMap
from avlmaps_torch.robot.sim import KinematicSimulator
from avlmaps_torch.utils import category_assigner as tca
from avlmaps_torch.utils import visualize as tvis
from tests.test_nav_robot import CS, GS, VH, make_scene


@pytest.fixture(scope="module")
def imaps(tmp_path_factory):
    scene = make_scene(tmp_path_factory.mktemp("imap") / "scene",
                       np.random.default_rng(0))
    out = []
    for load, cls, kw in ((jax_load_config, JaxImap, {}),
                          (load_config, InteractiveMap, {"device": "cpu"})):
        cfg = load()
        cfg.map_config.grid_size = GS
        cfg.map_config.cell_size = CS
        cfg.map_config.pose_info.camera_height = CS * VH
        out.append(cls(scene, cfg.map_config, **kw))
    return out  # (jax, torch)


def test_interactive_map_matches_jax(imaps):
    jm, tm = imaps
    for start, toward in (((10.0, 10.0), (5.0, 10.0)),
                          ((20.0, 15.0), (22.0, 30.0)),
                          ((3.5, 7.25), (9.0, 1.0))):
        np.testing.assert_array_equal(
            tm.get_habitat_robot_state(start, toward),
            jm.get_habitat_robot_state(start, toward))
    rgb = tm.cropped_rgb_map()
    np.testing.assert_array_equal(rgb, jm.cropped_rgb_map())
    path = [(5, 5), (20, 20), (30, 10)]
    np.testing.assert_array_equal(tm.draw_path(rgb, path),
                                  jm.draw_path(rgb, path))
    boxes = [(2, 10, 3, 12), (15, 25, 5, 9)]
    np.testing.assert_array_equal(tm.draw_boxes(rgb, boxes),
                                  jm.draw_boxes(rgb, boxes))
    tm.set_map_positions([(1, 2), (3.5, 4)])
    assert tm.coords == [(1, 2), (3.5, 4)]


def test_play_actions_matches_jax(imaps):
    jm, tm = imaps
    tm.vlmaps_dataloader.from_cropped_map_pose(10, 10, 30.0)
    init = tm.vlmaps_dataloader.to_habitat_tf()
    actions = (["move_forward"] * 4 + ["turn_left"] * 6 + ["stop"]
               + ["move_forward"] * 3 + ["turn_right"] * 2)
    got = tm.play_actions(KinematicSimulator(0.1, 5.0), init, actions)
    want = jm.play_actions(JaxSim(0.1, 5.0), init, actions)
    assert got == want and len(got) == len(actions)


def _cloud():
    rng = np.random.default_rng(0)
    pc = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (300, 3)).astype(np.uint8)
    heat = rng.uniform(0, 1, 300).astype(np.float32)
    return pc, rgb, heat


def test_visualize_matches_jax(tmp_path):
    pc, rgb, heat = _cloud()
    np.testing.assert_array_equal(tvis.convert_heatmap_to_rgb(heat, rgb),
                                  jvis.convert_heatmap_to_rgb(heat, rgb))
    for mod, name in ((tvis, "t"), (jvis, "j")):
        mod.write_ply(tmp_path / f"{name}.ply", pc, rgb)
        out = mod.visualize_heatmap_3d(pc, heat, rgb, save_path=tmp_path
                                       / f"{name}_heat.ply")
        assert out == tmp_path / f"{name}_heat.ply"
        out = mod.visualize_masked_map_3d(pc, heat > 0.5, rgb,
                                          save_path=tmp_path
                                          / f"{name}_mask.ply")
        assert out.exists()
    for kind in ("", "_heat", "_mask"):
        assert (tmp_path / f"t{kind}.ply").read_text() == \
            (tmp_path / f"j{kind}.ply").read_text()
    png = tvis.visualize_heatmap_3d(pc, heat, rgb,
                                    save_path=tmp_path / "h.png")
    assert png is not None and png.stat().st_size > 1000


@pytest.mark.parametrize("num_cls", [1, 8, 41, 150])
def test_palettes_match_jax(num_cls):
    palette = tvis.get_new_palette(num_cls)
    assert palette == jvis.get_new_palette(num_cls)
    labels = np.random.default_rng(num_cls).integers(0, num_cls, (12, 16))
    names = [f"c{i}" for i in range(num_cls)]
    got_img, got_patches = tvis.get_new_mask_palette(
        labels, palette, out_label_flag=True, labels=names,
        ignore_ids_list=[0])
    want_img, want_patches = jvis.get_new_mask_palette(
        labels, palette, out_label_flag=True, labels=names,
        ignore_ids_list=[0])
    np.testing.assert_array_equal(np.asarray(got_img), np.asarray(want_img))
    assert got_img.getpalette() == want_img.getpalette()
    assert [p.get_label() for p in got_patches] == \
        [p.get_label() for p in want_patches]


def test_category_assigner_matches_jax():
    cats = ["glass", "door", "dog"]
    items = [(1, 2), (3, 4), (5, 6), (7, 8)]
    tracks = []
    for mod in (tca, jca):
        a = mod.CategoryAssigner(cats, items)
        a.assign("door")
        a.skip()
        a.back()
        a.assign("dog")
        a.assign("glass")
        assert not a.done and a.current_item == (7, 8)
        a.skip()
        a.skip()
        with pytest.raises(ValueError):
            a.assign("cat")
        tracks.append((a.results(), a.cursor, a.done, a.current_item))
    assert tracks[0] == tracks[1]
    assert tracks[0][0] == [((1, 2), "door"), ((3, 4), "dog"),
                            ((5, 6), "glass"), ((7, 8), None)]
