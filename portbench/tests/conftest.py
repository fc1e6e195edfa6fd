"""The benchmark's tests: run by hand with ``python -m pytest
portbench/tests -q`` from the checkout's root (the repository's own
suite does not collect them).  Tests marked ``cuda`` need a card and skip
without one; run them on the card with ``python -m pytest portbench/tests
-q -m cuda``."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import registry  # noqa: E402

# tiny shapes for the CPU: the widths of the port's tiny16 LSeg and tiny
# CLIP, 96x128 frames with their own camera, a small grid
TINY_LSEG = {
    "encoder": {"width": 32, "layers": 4, "heads": 2, "hooks": [0, 1, 2, 3],
                "pretrain_grid": 2, "features": 16,
                "reassemble_ch": [8, 16, 32, 32], "out_dim": 24},
    "text": {"embed_dim": 24, "width": 32, "layers": 2, "heads": 2,
             "vision": {"image_size": 32, "patch_size": 8, "width": 32,
                        "layers": 2}},
    "map": {"image_hw": [96, 128],
            "cam_calib_mat": [64, 0, 64, 0, 64, 48, 0, 0, 1],
            "grid_size": 200, "capacity": 40000, "lseg_base_size": 80,
            "lseg_crop_size": 64, "batch_size": 4}}
TINY_CLIP = {
    "text": {"embed_dim": 24, "width": 32, "layers": 2, "heads": 2,
             "vision": {"image_size": 32, "patch_size": 8, "width": 32,
                        "layers": 2, "heads": 1}},
    "area": {"batch_size": 4}}
TINY_SCENE = {"frames": 8, "hw": [96, 128], "step_m": 0.05, "yaw_deg": 5.0,
              "room_m": 4.0, "ceiling_m": 3.0, "boxes": 2, "scene_seed": 3}
SEED = 2 ** 31 + 11


def tiny_cell(name: str):
    """(workload, configuration override) of cell ``name`` at the tiny
    shapes."""
    wl = registry.workload(name)
    if "scene" in wl:
        wl["scene"] = dict(TINY_SCENE)
    if "scene_map" in wl:
        wl["scene_map"] = dict(
            wl["scene_map"], image_hw=[96, 128],
            cam_calib_mat=TINY_LSEG["map"]["cam_calib_mat"],
            lseg_base_size=80, lseg_crop_size=64)
    if "voxels" in wl:
        wl.update(voxels=2000, grid=[40, 40, 10], k=8, checked_queries=3)
    over = TINY_CLIP if wl["config"] == "clip-vitl14" else TINY_LSEG
    return wl, over


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
    if os.environ.get("PYTEST_XDIST_WORKER"):  # workers share the cores
        import torch

        torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def own_cache(request, tmp_path_factory, monkeypatch):
    """Each test process its own scene cache for the tiny scenes:
    parallel workers never write one another's.  A test on the card uses
    the checkout's cache, as a run does."""
    import portbench.run as R

    if "card" not in request.fixturenames:
        monkeypatch.setattr(R, "CACHE", tmp_path_factory.getbasetemp()
                            / "portbench-cache")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
