"""BENCHMARK.json against the contract's shape, and every file it names:
configurations, workload files, drivers and per-layer readers."""
from __future__ import annotations

import json
import re

import pytest

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = bench.benchmark()
WIDTHS = ("hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
          "num_key_value_heads", "width", "feature_width", "view_hidden")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_time_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    cfg = bench.load_json(bench.ROOT / c["file"])
    assert cfg["name"] == c["name"] and c["file"].startswith("portbench/")
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert not set(c["reduced"]) & set(WIDTHS)
    assert all(k in cfg["assumed"] for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = bench.find_cell(w["name"])
    assert (bench.HERE / "drivers" / f"{cell.workload['driver']}.py").exists()
    assert callable(bench.driver(cell.workload["driver"]).run)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.workload["limits"]


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert callable(bench.reader(m["name"]).read)


def test_setup_bound():
    setup = {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup
