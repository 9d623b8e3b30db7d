"""Find what a run needs by name: the benchmark's own entries in
``BENCHMARK.json``, a cell's file, a configuration's file, a traffic kind's
generator, a driver, and one reader per metric.

Every piece sits in a file of its own under ``benchmark/``, so a cell,
configuration, traffic kind or metric is added by adding files:

- ``workloads/<cell>.json``: the cell (configuration, driver, traffic kind
  and its parameters, the limits of its correctness check);
- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<kind>.py``: one generator per traffic kind;
- ``drivers/<driver>.py``: what drives the program under that traffic;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str) -> Dict:
    return json.loads(
        (BENCH_DIR / "workloads" / f"{_name(name)}.json").read_text())


def load_config(name: str) -> Dict:
    return json.loads(
        (BENCH_DIR / "configs" / f"{_name(name)}.json").read_text())


def traffic_kind(kind: str) -> ModuleType:
    return importlib.import_module(f"benchmark.traffic.{_name(kind)}")


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.drivers.{_name(name)}")


def metric_reader(name: str) -> ModuleType:
    """The reader of one metric: ``metrics/<name>.py``, loaded by path
    (a metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{_name(name)}.py"
    mod_name = "benchmark.metrics._" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: Dict, cell: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def metrics_of(bench: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
