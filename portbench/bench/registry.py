"""Find a cell's files by name.

``BENCHMARK.json`` (the checkout's root) lists the cells and metrics;
``portbench/workloads/<cell>.json`` holds a cell's traffic and names its
configuration and driver; ``portbench/configs/<config>.json`` (+ ``.py``)
a configuration; ``portbench/drivers/<driver>.py`` a window loop;
``portbench/metrics/<metric>.py`` one per-layer reader.  A new cell,
configuration, driver or metric is a new file: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH_DIR.parent  # the checkout


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest(root: Path = ROOT) -> dict:
    """``BENCHMARK.json``; a checkout without it cannot run a cell."""
    return read_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as module ``name`` (file names
    carry dots and dashes, so not through the import system's names)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    wl = read_json(BENCH_DIR / "workloads" / f"{name}.json")
    wl["name"] = name
    return wl


def config(name: str) -> dict:
    """The configuration's JSON, with ``module``: its ``.py`` (weights,
    FLOP counts), or None when it has none."""
    cfg = read_json(BENCH_DIR / "configs" / f"{name}.json")
    py = BENCH_DIR / "configs" / f"{name}.py"
    cfg["module"] = (load_module(py, f"portbench_config_{_ident(name)}")
                     if py.exists() else None)
    return cfg


def driver(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "drivers" / f"{name}.py",
                       f"portbench_driver_{_ident(name)}")


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"portbench_metric_{_ident(name)}")


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def cell_metrics(man: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``cell`` reports: an entry
    with ``workloads`` names its cells; a per-layer entry without it is
    reported wherever the metric it ``moves`` is."""
    def listed(m: dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in man["end_to_end"] if listed(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def names(kind: str) -> List[str]:
    """The names that have a file of ``kind`` (configs, workloads,
    drivers, metrics)."""
    suffix = ".json" if kind in ("configs", "workloads") else ".py"
    return sorted(p.name[:-len(suffix)]
                  for p in (BENCH_DIR / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))
