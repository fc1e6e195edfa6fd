"""The port stands alone: no JAX, nothing of avlmaps_tpu, and its entry
points never fall back to the CPU silently."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = sorted((REPO / "avlmaps_torch").rglob("*.py"))
SOURCES = PACKAGE + [REPO / "chip_smoke.py"] + sorted(
    (REPO / "probes").glob("*.py"))
# msgpack: the card's machine has neither it nor flax (utils/msgpack.py
# reads flax's files with the standard library)
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "avlmaps_tpu", "tools")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _unheld_pointers(path: Path):
    """Lines where ``.data_ptr()`` is taken of a call's result, e.g.
    ``f(x).data_ptr()`` or ``x.contiguous().data_ptr()``: no name holds
    that tensor, so it can be freed before the kernel that reads the
    pointer is on the stream."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "data_ptr"
                and isinstance(node.func.value, ast.Call)):
            yield node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_kernel_pointers_come_from_held_tensors(path):
    bad = list(_unheld_pointers(path))
    assert not bad, (f"{path.relative_to(REPO)}:{bad} passes the pointer "
                     "of a temporary tensor; bind it to a name that lives "
                     "until the launch has returned")


def test_unheld_pointer_scan_finds_the_pattern(tmp_path):
    src = tmp_path / "launch.py"
    src.write_text("lib.f(a.data_ptr(), g(s).data_ptr(),\n"
                   "      x.contiguous().data_ptr())\n")
    assert list(_unheld_pointers(src)) == [1, 2]


def test_sources_cover_the_package():
    names = {p.relative_to(REPO / "avlmaps_torch").as_posix()
             for p in PACKAGE}
    assert {"map/vlmap_builder.py", "ops/fused_vit.py",
            "ops/segment_scatter.py", "ops/voxel_fusion.py",
            "models/lseg/vit.py", "kernels/build.py",
            "models/clip/tokenizer.py", "models/clip/model.py",
            "models/clip/port.py", "models/clip/features.py",
            "ops/similarity.py", "ops/heatmap.py", "ops/delivery.py",
            "ops/pooling.py", "ops/morphology.py",
            "utils/category_matching.py", "map/map_base.py",
            "map/vlmap.py", "map/avlmap.py", "parallel/__init__.py",
            "parallel/sharded.py", "parallel/dryrun.py", "utils/msgpack.py",
            "utils/llm.py", "tools/recall_parity.py",
            "tools/reference_lseg.py", "tools/loc_eval.py",
            "tools/planner_eval.py", "tools/pack_scene.py",
            "dataset/generate_dataset.py",
            "dataset/sound_nav_tasks.py"} <= names


def test_make_mesh_needs_a_card_or_explicit_devices(monkeypatch):
    from avlmaps_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.size == 2
    assert make_mesh(1, devices=["cpu"] * 2).size == 1
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh(devices=["cuda:0"] * 4)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch,
                                                               tmp_path):
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.vlmap_builder import (VLMapBuilder,
                                                 make_frame_step_canvas)
    from avlmaps_torch.models.lseg import LSegConfig, LSegNet
    from avlmaps_torch.ops.voxel_fusion import (init_fusion_state,
                                                restore_fusion_state)

    _no_card(monkeypatch)
    mc = load_config().map_config
    with pytest.raises(RuntimeError, match="no CUDA card"):
        VLMapBuilder(tmp_path, mc, tmp_path / "poses.txt", [], [], None,
                     None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_fusion_state(8, 2, 16, 32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        restore_fusion_state(8, 2, 32, *([None] * 4))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LSegNet(LSegConfig.tiny16())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_frame_step_canvas(lambda x: x, gs=8, cs=0.1, vh=2,
                               calib_mat=mc.calib_matrix(),
                               image_hw=(32, 32), base_size=32,
                               crop_size=32)


def test_query_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    import numpy as np

    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.avlmap import AVLMap
    from avlmaps_torch.map.vlmap import VLMap
    from avlmaps_torch.models.clip import ClipEncoder
    from avlmaps_torch.ops.delivery import (make_object_query,
                                            make_text_object_query)
    from avlmaps_torch.ops.heatmap import heatmap_from_mask_3d

    cpu_encoder = ClipEncoder("tiny", device="cpu")
    _no_card(monkeypatch)
    cfg = load_config()
    calls = [
        lambda: ClipEncoder("tiny"),
        lambda: VLMap(cfg.map_config),
        lambda: AVLMap(cfg),
        lambda: make_text_object_query(cpu_encoder, (8, 8, 4)),
        lambda: make_object_query((8, 8, 4)),
        lambda: heatmap_from_mask_3d(np.zeros((4, 3), np.int32),
                                     np.ones(4, bool)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_cpu_is_taken_only_when_asked(monkeypatch):
    from avlmaps_torch.ops.voxel_fusion import init_fusion_state

    _no_card(monkeypatch)
    state = init_fusion_state(8, 2, 16, 32, device="cpu")
    assert state.accum.device.type == "cpu"
    assert state.accum.shape == (33, 16 + 128)


def test_kernels_build_lazily():
    """Importing the kernel wrappers neither builds nor loads a library,
    and every kernel source is loaded by some wrapper module."""
    import importlib
    import re

    from avlmaps_torch.kernels import build

    loaded = set()
    for path in sorted((REPO / "avlmaps_torch" / "ops").glob("*.py")):
        importlib.import_module(f"avlmaps_torch.ops.{path.stem}")
        loaded |= set(re.findall(
            r'(?:build\.load\(|_LIB = )"(\w+)"', path.read_text()))
    assert build._libs == {}
    assert build.sources() and set(build.sources()) <= loaded


def test_slice_3_modules_are_scanned():
    names = {p.relative_to(REPO / "avlmaps_torch").as_posix()
             for p in PACKAGE}
    assert {"utils/threefry.py", "pipeline/packed.py",
            "pipeline/transport.py", "pipeline/loader.py"} <= names


def test_slice_3_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.vlmap_builder import (
        make_frame_step, make_frame_step_device_sampled)

    _no_card(monkeypatch)
    kw = dict(gs=8, cs=0.1, vh=2, calib_mat=load_config().map_config
              .calib_matrix(), image_hw=(32, 32), base_size=32, crop_size=32)
    for factory in (make_frame_step, make_frame_step_device_sampled):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            factory(lambda x: x, **kw)


def test_slice_8_modules_are_scanned():
    names = {p.relative_to(REPO / "avlmaps_torch").as_posix()
             for p in PACKAGE}
    assert {"models/superpoint/model.py", "models/superpoint/port.py",
            "models/superglue/model.py", "models/superglue/port.py",
            "models/netvlad/model.py", "models/netvlad/port.py",
            "models/wav2clip.py", "map/visual_map.py",
            "utils/esc50.py"} <= names


def test_slice_8_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.visual_map import VisualMap
    from avlmaps_torch.models.netvlad import NetVLADConfig, NetVLADEncoder
    from avlmaps_torch.models.superglue import (SuperGlueConfig,
                                                SuperGlueMatcher)
    from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                                 SuperPointExtractor)
    from avlmaps_torch.models.wav2clip import Wav2ClipConfig, Wav2ClipEncoder

    _no_card(monkeypatch)
    calls = [
        lambda: VisualMap(load_config().map_config),
        lambda: SuperPointExtractor(SuperPointConfig.tiny()),
        lambda: SuperGlueMatcher(SuperGlueConfig.tiny()),
        lambda: NetVLADEncoder(NetVLADConfig.tiny()),
        lambda: Wav2ClipEncoder(Wav2ClipConfig.tiny()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_slice_9_modules_are_scanned():
    names = {p.relative_to(REPO / "avlmaps_torch").as_posix()
             for p in PACKAGE}
    assert {"map/vlmap_builder_multi_floor.py", "map/interactive_map.py",
            "nav/visgraph.py", "nav/native.py", "nav/navigator.py",
            "nav/controller.py", "robot/sim.py", "robot/lang_robot.py",
            "robot/habitat_lang_robot.py", "task/tasks.py",
            "utils/categories.py", "utils/category_assigner.py",
            "utils/visualize.py", "application/create_map.py",
            "application/generate_obstacle_map.py",
            "application/index_map.py"} <= names


def test_slice_9_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch, tmp_path):
    from avlmaps_torch.config import load_config
    from avlmaps_torch.map.map_base import Map
    from avlmaps_torch.map.vlmap_builder_multi_floor import (
        VLMapBuilderMultiFloor, VLMapMultiFloor)
    from avlmaps_torch.robot import HabitatLanguageRobot, LangRobot

    _no_card(monkeypatch)
    cfg = load_config()
    calls = [
        lambda: VLMapBuilderMultiFloor(tmp_path, cfg.map_config, [], [], []),
        lambda: VLMapMultiFloor(cfg.map_config),
        lambda: Map.create(cfg.map_config),
        lambda: LangRobot(cfg),
        lambda: HabitatLanguageRobot(cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_the_port_never_writes_next_to_the_native_source():
    """The port's visgraph library lives in its build directory; the
    JAX package's loader writes native/visgraph.so, the port's never
    names it."""
    from avlmaps_torch.nav import native

    assert native.library_path().parent == REPO / "avlmaps_torch" / "_build"
    assert "visgraph.so" not in (REPO / "avlmaps_torch" / "nav"
                                 / "native.py").read_text()
