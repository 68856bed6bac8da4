"""The benchmark's files: BENCHMARK.json, the cells, configurations and
metric readers it names, and the characters their names may use."""

from __future__ import annotations

import json
import re

import pytest

from portbench.tests.helpers import REPO
from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = sorted(p.stem for p in (cells.HERE / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (cells.HERE / "configs").glob("*.json"))


def test_benchmark_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_file(name):
    cell, config = cells.load_cell(name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert NAME.match(name) and NAME.match(cell["traffic"]["name"])
    assert entry["config"] == cell["config"] == config["name"]
    assert entry["traffic"] == cell["traffic"]["name"]
    assert entry["chips"] == cell["chips"] == 1
    assert entry["why"] == cell["why"] and len(cell["why"]) <= 200
    assert set(cell["limits"]) == {"f_gap", "av_gap"}
    assert cells.kind(cell).inputs  # its job kind is found


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file(name):
    config = cells.load_json(f"configs/{name}.json")
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    assert NAME.match(name) and config["name"] == name
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert entry["reduced"] == config["reduced"] == []
    assert entry["source"].startswith("https://")
    assert (cells.HERE / config["reference"]).exists()
    for rel in config["obstacles"].values():
        assert (cells.HERE / rel).exists()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_named_and_readable(kind):
    names = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(cells.metric(m["name"]).read)
        assert set(m.get("workloads", names)) <= set(names)
        if kind == "per_layer":
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        else:
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    from portbench import harness

    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


def test_configs_and_cells_used_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
