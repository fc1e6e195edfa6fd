"""What ``run.py`` prints: the last line of standard output holds the
result's keys and nothing else, ``checks`` last (each number compared
beside its limit, repeated as the last lines of standard error), and the
write counts come on a line before it."""

import json

import pytest

import portbench.run as R
from portbench.bench import device as bdev
from conftest import SEED, tiny_cell

RESULT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def tiny_main(monkeypatch):
    """``run.main`` past the look for a card, on the CPU at tiny shapes."""
    real = R.run_cell

    def run_tiny(wl, seed, seconds, trace, device, man):
        wl, over = tiny_cell(wl["name"])
        return real(wl, seed, seconds, trace, "cpu", man,
                    cfg_override=over, t_start=R.time.perf_counter())

    monkeypatch.setattr(R, "run_cell", run_tiny)
    monkeypatch.setattr(bdev, "require_cards", lambda n: None)

    def main(cell, trace, capsys):
        rc = R.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "0.3", "--trace", str(trace)])
        out, err = capsys.readouterr()
        return rc, out.strip().splitlines(), err.strip().splitlines()
    return main


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_holds_only_the_result(tiny_main, capsys, trace):
    rc, out, err = tiny_main("lseg-vitl16.build.packed", trace, capsys)
    assert rc == 0
    line = json.loads(out[-1])
    want = RESULT + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, (value, limit) in line["checks"].items():
        assert f"check {name} = {value!r} (limit {limit!r})" in err
    assert err[-len(line["checks"]):] == [
        f"check {k} = {v!r} (limit {lim!r})"
        for k, (v, lim) in line["checks"].items()]


def test_write_counts_come_before_the_result(tiny_main, capsys):
    rc, out, err = tiny_main("lseg-vitl16.query.object", 0, capsys)
    assert rc == 0
    io = [ln for ln in out[:-1] if ln.startswith("portbench io: ")]
    assert len(io) == 1 and out.index(io[0]) < len(out) - 1
    counts = json.loads(io[0][len("portbench io: "):])
    assert counts["scene_cache_created_bytes"] >= 0
    if R.io_counts():
        assert counts["write_bytes"] >= 0
        assert "cancelled_write_bytes" in counts
    assert io[0] in err


def test_scene_cache_growth_is_counted(tiny_main, capsys, monkeypatch,
                                       tmp_path):
    monkeypatch.setattr(R, "CACHE", tmp_path / "fresh")
    _, out, _ = tiny_main("lseg-vitl16.build.packed", 0, capsys)
    first = json.loads(out[-2][len("portbench io: "):])
    _, out, _ = tiny_main("lseg-vitl16.build.packed", 0, capsys)
    second = json.loads(out[-2][len("portbench io: "):])
    assert first["scene_cache_created_bytes"] == R.tree_bytes(
        tmp_path / "fresh") > 0
    assert second["scene_cache_created_bytes"] == 0


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        R.main(["--workload", "lseg-vitl16.query.object", "--seed", "1",
                "--seconds", "1", "--trace", "0"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_no_program_no_result(monkeypatch, capsys):
    monkeypatch.setattr(R, "PROGRAM", "avlmaps_torch_not_here")
    assert R.main(["--workload", "lseg-vitl16.query.object", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
