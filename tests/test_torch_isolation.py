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
FORBIDDEN = ("jax", "jaxlib", "flax", "avlmaps_tpu", "tools")


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
            "map/vlmap.py", "map/avlmap.py"} <= names


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
    """Importing the kernel wrappers neither builds nor loads a library."""
    import importlib

    from avlmaps_torch.kernels import build

    importlib.import_module("avlmaps_torch.ops.fused_vit")
    importlib.import_module("avlmaps_torch.ops.segment_scatter")
    importlib.import_module("avlmaps_torch.ops.similarity")
    importlib.import_module("avlmaps_torch.ops.delivery")
    assert build._libs == {}
    assert set(build.sources()) == {"fused_vit", "segment_scatter",
                                    "similarity"}


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
