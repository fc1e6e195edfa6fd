"""BENCHMARK.json against the benchmark's rules, and every name in it
backed by its own file."""

import json
import re

import pytest

from portbench.bench import registry

MAN = registry.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    raw = (registry.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert _one_line(word) and not word.startswith("/") \
            and ".." not in word
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert _one_line(e[key]), (e["name"], key)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    """setup_s, one more end-to-end metric and a per-layer one; every
    per-layer metric a cell reports moves an end-to-end metric that the
    cell reports too."""
    for w in MAN["workloads"]:
        chosen = registry.cell_metrics(MAN, w["name"])
        e2e = {m["name"] for m in chosen["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert chosen["per_layer"], w["name"]
        for m in chosen["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_name_has_its_file():
    """Each configuration, cell, driver and per-layer metric is a file of
    its own, found by its name."""
    for c in MAN["configs"]:
        cfg = registry.config(c["name"])
        assert cfg["name"] == c["name"]
        assert list(cfg["reduced"]) == c["reduced"]
        assert (registry.ROOT / c["file"]).exists()
    for w in MAN["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["traffic"] == w["traffic"] and wl["why"] == w["why"]
        assert hasattr(registry.driver(wl["driver"]), "window")
    for m in MAN["per_layer"]:
        assert hasattr(registry.metric_reader(m["name"]), "read")


def test_run_names_no_cell():
    src = (registry.BENCH_DIR / "run.py").read_text()
    for w in MAN["workloads"]:
        assert w["name"] not in src and w["config"] not in src
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        if m["name"] != "setup_s":
            assert f'"{m["name"]}"' not in src


def test_limits_are_numbers():
    for w in MAN["workloads"]:
        limits = registry.workload(w["name"]).get("limits", {})
        assert limits, w["name"]
        assert all(isinstance(v, (int, float)) and v >= 0
                   for v in limits.values())
    json.dumps(MAN)
