"""Each cell's whole run at tiny shapes on the CPU, past the look for a
card: the result line's keys, the metrics it reports, and ``correct``."""

import math

import pytest

import portbench.run as R
from portbench.bench import registry
from conftest import SEED, tiny_cell

MAN = registry.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def run_tiny(name, trace=False, seed=SEED):
    wl, over = tiny_cell(name)
    return R.run_cell(wl, seed, 0.3, trace, "cpu", MAN, cfg_override=over,
                      t_start=R.time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run(name):
    line = run_tiny(name)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    want = {m["name"] for m in registry.cell_metrics(MAN, name)
            ["end_to_end"]}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 and math.isfinite(v["value"])
               for v in line["metrics"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    line = run_tiny(name, trace=True)
    dev = line["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in registry.cell_metrics(MAN, name)
               ["per_layer"]}
    assert set(line["metrics"]) <= allowed
    assert line["correct"], line["checks"]


def test_same_seed_same_answer():
    a = run_tiny("lseg-vitl16.build.packed", seed=5)
    b = run_tiny("lseg-vitl16.build.packed", seed=5)
    assert a["checks"] == b["checks"]
