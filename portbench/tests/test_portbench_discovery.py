"""A new configuration, cell or per-layer metric is a new file, found by
its name, with no other file edited."""

import json
import shutil
from types import SimpleNamespace

import pytest

from portbench.bench import registry


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's folder that the registry reads."""
    dst = tmp_path / "portbench"
    shutil.copytree(registry.BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    monkeypatch.setattr(registry, "BENCH_DIR", dst)
    return dst


def test_new_config_found(bench_copy):
    cfg = json.loads((bench_copy / "configs" / "clip-vitl14.json")
                     .read_text())
    cfg["name"] = "clip-vitb16"
    (bench_copy / "configs" / "clip-vitb16.json").write_text(
        json.dumps(cfg))
    assert "clip-vitb16" in registry.names("configs")
    got = registry.config("clip-vitb16")
    assert got["name"] == "clip-vitb16" and got["module"] is None


def test_new_cell_found(bench_copy):
    wl = json.loads((bench_copy / "workloads"
                     / "lseg-vitl16.query.object.json").read_text())
    wl["traffic"] = "query.burst"
    (bench_copy / "workloads" / "lseg-vitl16.query.burst.json").write_text(
        json.dumps(wl))
    assert "lseg-vitl16.query.burst" in registry.names("workloads")
    assert registry.workload("lseg-vitl16.query.burst")["traffic"] \
        == "query.burst"


def test_new_metric_found_and_selected(bench_copy):
    (bench_copy / "metrics" / "query.delivery_ms.py").write_text(
        "def read(view):\n"
        "    ns = view.summary['under_ns'].get('query.delivery', 0)\n"
        "    return ns / 1e6 if ns else None\n")
    assert "query.delivery_ms" in registry.names("metrics")
    reader = registry.metric_reader("query.delivery_ms")
    view = SimpleNamespace(summary={"under_ns": {"query.delivery": 2e6}})
    assert reader.read(view) == 2.0
    man = json.loads(json.dumps(registry.manifest()))
    man["per_layer"].append({
        "name": "query.delivery_ms", "unit": "ms/query", "better": "lower",
        "source": "device_trace", "layer": "query entry and delivery",
        "moves": "query_qps"})
    names = {m["name"] for m in registry.cell_metrics(
        man, "lseg-vitl16.query.object")["per_layer"]}
    assert "query.delivery_ms" in names
    builds = {m["name"] for m in registry.cell_metrics(
        man, "lseg-vitl16.build.packed")["per_layer"]}
    assert "query.delivery_ms" not in builds


def test_reader_with_nothing_to_read_returns_none():
    view = SimpleNamespace(
        summary={"under_ns": {}, "unranged_ns": {}, "kernel_ns": {},
                 "busy_ns": 0, "window_ns": 1, "device_ns": 0},
        counts={}, window={"metrics": {}, "counts": {}},
        cfg={"module": None}, workload={})
    for m in registry.manifest()["per_layer"]:
        if m["name"] in ("query.enqueue_ms",):
            continue
        assert registry.metric_reader(m["name"]).read(view) is None, m
