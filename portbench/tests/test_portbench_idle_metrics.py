"""The readers of idle device time under the program's spans
(``trace/idle.py`` and the ``*_idle_ms`` metrics) on synthetic summaries,
and ``counting.summarise`` naming a gap by the innermost of nested
ranges."""

import json
from types import SimpleNamespace

import pytest

from portbench.bench import registry
from portbench.trace import counting, idle

# metric -> (the ranges it reads, its count)
READERS = {
    "build.setup_idle_ms": (("build.setup",), "frames"),
    "build.wait_idle_ms": (("build.wait_input",), "frames"),
    "build.step_idle_ms": (("build.step", "build.geometry", "build.sample",
                            "build.lseg", "build.colour", "build.fuse",
                            "lseg.vit", "lseg.dpt", "lseg.head"), "frames"),
    "build.save_idle_ms": (("build.export", "build.save"), "frames"),
    "area.read_idle_ms": (("area.read",), "frames"),
    "area.preprocess_idle_ms": (("clip.preprocess",), "frames"),
    "query.tokenize_idle_ms": (("query.tokenize",), "queries"),
}
# gaps under the harness's spans, with no range, or under ranges no
# reader takes; each a distinct number of ns so a wrong sum shows
OTHERS = [["bench.build", 1], ["bench.build / aten::copy_", 2],
          ["bench.area_build", 4], ["bench.query / aten::empty", 8],
          ["host (no torch op)", 16], ["query.text_encode", 32],
          ["query.text_encode / aten::addmm", 64], ["build.setupx", 128],
          ["xbuild.save", 256]]


def _view(gaps, counts):
    return SimpleNamespace(summary={"idle": gaps}, counts=counts)


def test_idle_ns_matches_the_range_part_only():
    gaps = [["build.save", 1000], ["build.save / aten::copy_", 2000],
            ["bench.build / build.save", 4000], ["build.save_", 8000],
            ["aten::copy_ / build.save", 16000]]
    assert idle.idle_ns({"idle": gaps}, ["build.save"]) == 3000
    assert idle.idle_ns({"idle": gaps}, ("aten::copy_",)) == 16000
    assert idle.idle_ns({"idle": gaps}, ()) == 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_sums_its_ranges_over_its_count(name):
    spans, count = READERS[name]
    gaps = list(OTHERS)
    for i, span in enumerate(spans):
        gaps += [[span, 1000 * 2 ** i], [f"{span} / aten::mm", 3000]]
    want_ns = sum(1000 * 2 ** i + 3000 for i in range(len(spans)))
    read = registry.metric_reader(name).read
    assert read(_view(gaps, {count: 4})) == pytest.approx(want_ns / 1e6 / 4)
    # nothing under its ranges: a true zero, not a missing reading
    assert read(_view(list(OTHERS), {count: 4})) == 0.0
    assert read(_view(gaps, {})) is None


def test_step_idle_takes_nested_ranges_not_the_harness_span():
    gaps = [["bench.build", 5_000_000], ["lseg.vit", 1_000_000],
            ["lseg.dpt / aten::cudnn_convolution", 2_000_000],
            ["build.step / aten::pin_memory", 500_000],
            ["build.fuse", 250_000], ["build.wait_input", 7_000_000]]
    read = registry.metric_reader("build.step_idle_ms").read
    assert read(_view(gaps, {"frames": 10})) == pytest.approx(0.375)


def test_summarise_names_a_gap_by_the_innermost_range(tmp_path):
    """A build whose step and save run inside the harness's
    ``bench.build``: the idle gap in the middle of ``build.save`` is
    ``build.save``'s, the one after the step only the harness's."""
    host = dict(ph="X", pid=10, tid=11)
    dev = dict(ph="X", pid=0, tid=7)
    ev = [dict(host, cat="user_annotation", name=counting.WINDOW_SPAN,
               ts=0, dur=1000),
          dict(host, cat="user_annotation", name="bench.build", ts=0,
               dur=1000),
          dict(host, cat="user_annotation", name="build.step", ts=20,
               dur=20),
          dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=30,
               dur=2, args={"correlation": 1}),
          dict(dev, cat="kernel", name="k", ts=100, dur=400,
               args={"correlation": 1}),
          dict(host, cat="user_annotation", name="build.save", ts=600,
               dur=300),
          dict(host, cat="cpu_op", name="aten::copy_", ts=700, dur=100)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = counting.summarise(path)
    assert dict(s["idle"]) == {"bench.build": 100_000,
                               "build.save / aten::copy_": 500_000}
    assert s["under_ns"]["build.step"] == s["busy_ns"] == 400_000
    view = SimpleNamespace(summary=s, counts={"frames": 2})
    read = registry.metric_reader
    assert read("build.save_idle_ms").read(view) == pytest.approx(0.25)
    assert read("build.step_idle_ms").read(view) == 0.0
