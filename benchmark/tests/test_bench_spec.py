"""The benchmark's file against its contract, and every piece it names
found by name."""

import json
import math
import re

import pytest

from benchmark.harness import spec
from benchmark.harness.model import sizes

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        got = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2, cell
        layer = spec.metrics_of(BENCH, cell, "per_layer")
        assert layer, cell
        for m in layer:   # the metric it moves is reported in the cell
            assert m["moves"] in got, (cell, m["name"])
    assert "workloads" not in e2e["setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    entry = spec.cell_entry(BENCH, cell)
    c = spec.load_cell(cell)
    assert c["config"] == entry["config"] and entry["chips"] in (1, 4)
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    spec.driver(c["driver"]).run
    spec.traffic_kind(c["traffic"]["kind"])
    for section in ("end_to_end", "per_layer"):
        for m in spec.metrics_of(BENCH, cell, section):
            assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) == set(cfg["published"])
    for key in cfg["reduced"]:
        assert cfg[key] != cfg["published"][key], key
        # never a width: hidden, intermediate, latent, state or projection
        # sizes, *_dim, *_rank, head sizes, expansion, experts per token
        assert not re.search(r"(_dim$|_rank$|hidden|intermediate|latent|"
                             r"state|proj|head|embd$|inner|expan|experts_per)",
                             key), key
    assert any(entry["name"] == w["config"] for w in BENCH["workloads"])
    s = sizes(cfg)
    assert s["h"] in (64, 128)


def test_cell_files_keys():
    for cell in CELLS:
        c = spec.load_cell(cell)
        assert {"config", "driver", "traffic", "check"} <= set(c)
        assert math.isfinite(float(c.get("trace_seconds", 1)))
