"""The port's robot (avlmaps_torch/robot), tasks and the voxel map's 2D
projections against the JAX package's, on copies of the nav scene of
tests/test_nav_robot.py with the same tiny CLIP weights
(``params_from_flax``), each robot on its own kinematic simulator:
action lists of ``move_to``, ``turn``, ``move_to_object`` and
``execute_code``, the 2D and 3D distribution maps, the region maps, the
goal picks and the task replay metrics."""

import json
import shutil

import numpy as np
import pytest

from avlmaps_tpu.config import load_config as jax_load_config
from avlmaps_tpu.map.vlmap import VLMap as JaxVLMap
from avlmaps_tpu.map.voxel_map import SparseVoxelMap as JaxSparseVoxelMap
from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.robot import HabitatLanguageRobot as JaxRobot
from avlmaps_tpu.robot import KinematicSimulator as JaxSim
from avlmaps_tpu.task import tasks as jtasks
from avlmaps_torch.config import load_config
from avlmaps_torch.map.vlmap import VLMap
from avlmaps_torch.map.voxel_map import SparseVoxelMap
from avlmaps_torch.models.clip import ClipEncoder, params_from_flax
from avlmaps_torch.models.clip.model import ClipConfig
from avlmaps_torch.robot import HabitatLanguageRobot, KinematicSimulator
from avlmaps_torch.task import tasks as ttasks
from tests.test_nav_robot import CS, GS, VH, make_scene
from tests.test_robot import TINY_CLIP

START = (40, 40, 0.0)


def _configure(cfg, root):
    cfg.params.gs = GS
    cfg.params.cs = CS
    cfg.map_config.grid_size = GS
    cfg.map_config.cell_size = CS
    cfg.map_config.pose_info.camera_height = CS * VH
    cfg.controller_config.gs = GS
    cfg.controller_config.cs = CS
    cfg.data_paths.avlmaps_data_dir = str(root)
    return cfg


def _setup(robot, vlmap_cls, enc):
    original = vlmap_cls._init_clip

    def patched(self, clip_version="ViT-B/32"):
        self.clip_encoder = enc
        return enc

    vlmap_cls._init_clip = patched
    try:
        robot.setup_scene(0)
    finally:
        vlmap_cls._init_clip = original
    return robot


def place(robot, row=START[0], col=START[1], ang=START[2]):
    robot.vlmaps_dataloader.from_full_map_pose(row, col, ang)
    robot.set_agent_state(robot.vlmaps_dataloader.to_habitat_tf())
    robot.empty_recorded_actions()


@pytest.fixture(scope="module")
def robots(tmp_path_factory):
    root = tmp_path_factory.mktemp("robots")
    jenc = JaxClipEncoder.from_config(TINY_CLIP)
    tenc = ClipEncoder.from_config(
        ClipConfig(**{k: getattr(TINY_CLIP, k)
                      for k in ClipConfig.__dataclass_fields__}),
        params=params_from_flax(jenc.params), device="cpu")
    out = []
    for name, load, robot_cls, sim_cls, vlmap_cls, enc, kw in (
            ("jax", jax_load_config, JaxRobot, JaxSim, JaxVLMap, jenc, {}),
            ("torch", load_config, HabitatLanguageRobot, KinematicSimulator,
             VLMap, tenc, {"device": "cpu"})):
        make_scene(root / name / "vlmaps_dataset" / "test_1",
                   np.random.default_rng(0))
        cfg = _configure(load(), root / name)
        # the obstacle customisation runs in test_customized_obstacles
        cfg.map_config.potential_obstacle_names = ()
        cfg.map_config.obstacle_names = ()
        robot = robot_cls(cfg, sim=sim_cls(cfg.params.forward_dist,
                                           cfg.params.turn_angle), **kw)
        out.append(_setup(robot, vlmap_cls, enc))
    return out  # (jax, torch)


def test_setup_matches_jax(robots):
    jr, tr = robots
    np.testing.assert_array_equal(tr.map.get_obstacle_cropped(),
                                  jr.map.get_obstacle_cropped())
    np.testing.assert_allclose(tr.map.scores_mat, jr.map.scores_mat,
                               rtol=0, atol=1e-5)
    # the labels agree wherever the top two scores are apart (41
    # categories in 8 dimensions leave a few near-ties)
    s = np.sort(jr.map.scores_mat, axis=1)
    clear = s[:, -1] - s[:, -2] > 1e-4
    np.testing.assert_array_equal(
        np.argmax(tr.map.scores_mat, 1)[clear],
        np.argmax(jr.map.scores_mat, 1)[clear])
    np.testing.assert_array_equal(tr.global_pc, jr.global_pc)
    assert tr.nav.visgraph.core == "native"
    assert len(tr.nav.visgraph.nodes) == len(jr.nav.visgraph.nodes)
    assert (tr.vlmaps_dataloader.rmin, tr.vlmaps_dataloader.cmin) == \
        (jr.vlmaps_dataloader.rmin, jr.vlmaps_dataloader.cmin)


def _both(robots, fn):
    return [fn(r) for r in robots]


def test_move_to_and_turn_match_jax(robots):
    for r in robots:
        place(r)
    jm, tm = _both(robots, lambda r: r.move_to((60, 60)))
    assert tm == jm and tm[-1] == "stop"
    jt, tt = _both(robots, lambda r: r.turn(90))
    assert tt == jt and len(tt) == 18
    jt, tt = _both(robots, lambda r: r.turn(-35))
    assert tt == jt
    for r in robots:
        r._set_nav_curr_pose()
    assert robots[1].get_agent_pose_on_map() == \
        robots[0].get_agent_pose_on_map()
    assert robots[1].recorded_robot_pos == robots[0].recorded_robot_pos
    np.testing.assert_allclose(robots[1].get_agent_tf(),
                               robots[0].get_agent_tf(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["door", "stool", "cabinet", "chair"])
def test_move_to_object_matches_jax(robots, name):
    for r in robots:
        place(r)
    _both(robots, lambda r: r.move_to_object(name))
    jr, tr = robots
    assert tr.get_recorded_actions() == jr.get_recorded_actions()
    assert "stop" in tr.get_recorded_actions()


def test_execute_code_matches_jax(robots):
    code = ("robot.turn(20)\nrobot.move_forward(0.3)\n"
            "robot.turn_absolute(-45)\nrobot.move_to_object('chair')\n"
            "robot.face('stool')\nrobot.with_object_on_left('towel')\n"
            "robot.move_north('door')\n"
            "robot.move_to(robot.get_pos('cabinet'))\n"
            "robot.move_to((50 + int(np.hypot(3, 4)), 45))\n")
    for r in robots:
        place(r)
        r.execute_code(code)
    jr, tr = robots
    assert tr.get_recorded_actions() == jr.get_recorded_actions()
    assert len(tr.get_recorded_actions()) > 0


@pytest.mark.parametrize("decay", [0.1, 0.03])
def test_3d_maps_and_goal_picks_match_jax(robots, decay):
    jr, tr = robots
    for name in ("chair", "sofa"):
        got = tr.get_vl_distribution_map_3d(name, decay_rate=decay)
        want = jr.get_vl_distribution_map_3d(name, decay_rate=decay)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pts = [tr.vlmaps_dataloader.to_habitat_tf()[:3, 3] + [0.3 * i, 0, 0.2]
           for i in range(3)]
    scores = np.array([0.2, 0.9, 0.5], np.float32)
    got = tr.get_distribution_map_3d("x", scores, pts, decay)
    want = jr.get_distribution_map_3d("x", scores, pts, decay)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    obj = jr.get_map_3d(obj="chair")
    major = jr.get_major_map_3d(obj="table")
    np.testing.assert_allclose(tr.get_map_3d(obj="chair"), obj, atol=1e-5)
    np.testing.assert_allclose(tr.get_major_map_3d(obj="table"), major,
                               atol=1e-5)
    fused = obj * want
    np.testing.assert_array_equal(tr.get_max_pos_3d(fused),
                                  jr.get_max_pos_3d(fused))
    assert tr.get_max_pos_3d_fused(obj, want) == \
        jr.get_max_pos_3d_fused(obj, want) == \
        tuple(int(v) for v in tr.map.grid_pos[np.argmax(fused)])


def test_2d_maps_match_jax(robots):
    jr, tr = robots
    for fn in (lambda r: r.get_map(obj="chair"),
               lambda r: r.get_major_map(obj="sofa")):
        got, want = fn(tr), fn(jr)
        assert got.shape == tr.map.get_obstacle_cropped().shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert tr.get_max_pos(got) == jr.get_max_pos(want)
    pos = [[5.0, 7.0], [20.0, 12.0], [30.5, 31.4]]
    scores = np.array([1.0, 0.3, 0.6])
    np.testing.assert_allclose(
        tr.get_distribution_map("x", scores, pos, 0.05),
        jr.get_distribution_map("x", scores, pos, 0.05), rtol=0, atol=1e-6)


def test_region_maps_match_jax(robots):
    jr, tr = robots
    tr.vlmaps_dataloader.from_full_map_pose(50, 50, 0.0)
    center = tr.vlmaps_dataloader.to_habitat_tf()[:3, 3]
    region_gt = {"kitchen": [{"region_center": center.tolist(),
                              "region_size": [1.0, 1.0, 1.0]}],
                 "bathroom": [{"region_center": (center + 0.8).tolist(),
                               "region_size": [0.5, 1.0, 0.6]}]}

    class Areas:
        robot_pose_list = []

        def index_map(self, name, with_init_cat=False):
            return np.linspace(0.1, 1.0, len(self.robot_pose_list))

    areas = Areas()
    for i in range(5):
        tr.vlmaps_dataloader.from_full_map_pose(35 + 6 * i, 60 - 4 * i,
                                                0.0)
        areas.robot_pose_list.append(tr.vlmaps_dataloader.to_habitat_tf())
    for r in robots:
        r.load_gt_region_map(region_gt)
        r.load_area_map("", area_map=areas)
    for kind in ("gt", "clip_sparse"):
        for r in robots:
            r.area_map_type = kind
        got = tr.get_region_distribution_map("kitchen", decay_rate=0.05)
        want = jr.get_region_distribution_map("kitchen", decay_rate=0.05)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.gt_region_map, jr.gt_region_map)
    for r in robots:
        r.area_map_type = "clip_sparse"


def test_customized_obstacles_match_jax(robots):
    jr, tr = robots
    names, keep = ["chair", "table", "sofa"], ["table"]
    for r in robots:
        r.map.customize_obstacle_map(names, keep)
    np.testing.assert_array_equal(tr.map.get_customized_obstacle_cropped(),
                                  jr.map.get_customized_obstacle_cropped())


def test_task_replay_matches_jax(robots, tmp_path):
    jr, tr = robots
    for r in robots:
        place(r, 50, 40, 0.0)
    init_tf = tr.get_agent_tf()
    actions = tr.move_to((40, 40))
    assert actions == jr.move_to((40, 40))
    metrics = []
    for r, mod, sim in ((jr, jtasks, JaxSim), (tr, ttasks,
                                                KinematicSimulator)):
        cfg = r.config
        spatial = mod.HabitatSpatialGoalNavigationTask(cfg)
        spatial.setup_scene(r.vlmaps_dataloader)
        spatial.task_dict = [{"task_id": 0,
                              "tf_habitat": init_tf.reshape(-1).tolist(),
                              "instruction": "go north",
                              "goals": [[[40, 40], [41, 40]], [[5, 5]]]}]
        spatial.setup_task(0)
        result = spatial.test_task(sim(cfg.params.forward_dist,
                                       cfg.params.turn_angle),
                                   actions + actions[-1:])
        spatial.save_single_task_metric(tmp_path / f"{mod.__name__}.json")

        obj = mod.HabitatObjectNavigationTask(cfg)
        obj.setup_scene(r.vlmaps_dataloader)
        obj.task_dict = [{"task_id": 0, "scene": "test",
                          "tf_habitat": init_tf.reshape(-1).tolist(),
                          "instruction": "go to the box",
                          "objects_info": [
                              {"name": "box", "center": init_tf[:3, 3]
                               .tolist(), "size": [0.5, 0.5, 0.5]},
                              {"name": "far", "center": [9.0, 0.0, 9.0]}]}]
        obj.setup_task(0)
        osim = sim(cfg.params.forward_dist, cfg.params.turn_angle)
        osim.set_agent_tf(init_tf)
        for a in ["move_forward", "stop", "turn_left", "stop"]:
            obj.test_step(osim, a)
        metrics.append((result, spatial.n_success_subgoals,
                        obj.distance_to_subgoals, obj.finished_subgoals,
                        obj.subgoal_success_rate, obj.success,
                        json.loads((tmp_path / f"{mod.__name__}.json")
                                   .read_text())))
    assert metrics[1] == metrics[0]
    assert metrics[1][0]["subgoal_success"][0]


def test_voxel_map_projections_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    m = SparseVoxelMap.empty(20, 12, 4)
    jm = JaxSparseVoxelMap.empty(20, 12, 4)
    assert m.num_occupied == 0 and (m.top_down_height() == -1).all()
    flat = rng.choice(20 * 20 * 12, 300, replace=False)
    pos = np.stack(np.unravel_index(flat, (20, 20, 12)), 1).astype(np.int32)
    for vm in (m, jm):
        vm.grid_pos = pos
        vm.grid_feat = rng.normal(size=(300, 4)).astype(np.float32)
        vm.occupied_ids[pos[:, 0], pos[:, 1], pos[:, 2]] = np.arange(300)
    np.testing.assert_array_equal(m.top_down_height(), jm.top_down_height())
    for band in ((0.0, 1.5), (0.1, 0.3), (0.2, 0.6)):
        np.testing.assert_array_equal(m.obstacle_map(*band),
                                      jm.obstacle_map(*band))
    # slot 0 never counts as an obstacle (the reference's ``> 0``)
    r, c, h = pos[0]
    only = SparseVoxelMap.empty(20, 12, 4)
    only.occupied_ids[r, c, h] = 0
    assert (only.obstacle_map(0.0, 100.0) == 1).all()
    shutil.rmtree(tmp_path, ignore_errors=True)
