"""Cells, configurations and metrics are added by adding files: a workload
and a metric reader dropped into a temporary folder are found and run,
with no file of the benchmark edited."""

from __future__ import annotations

import json

import pytest

from portbench.tests.helpers import SMALL_SCENE, SMALL_SWEEP, run_small, small_cell
from portbench import cells, harness


@pytest.mark.parametrize("base,traffic", [("refbox.1024", SMALL_SCENE),
                                          ("sweep128.omega64", SMALL_SWEEP)])
def test_dropped_cell_runs_correct(tmp_path, base, traffic):
    name = small_cell(tmp_path, base, "dropped." + base, **traffic)
    res = run_small(tmp_path, name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "mlups", "job_s_p90"}
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert res["device"]["platform"] == "cpu"


def test_dropped_config_and_metric(tmp_path):
    config = cells.load_json("configs/refbox.json")
    config.update(name="refbox_dropped", physics={**config["physics"], "accel_below_1024": 0.004})
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "refbox_dropped.json").write_text(json.dumps(config))
    name = small_cell(tmp_path, "refbox.1024", "dropped.metric", **SMALL_SCENE)
    cell = json.loads((tmp_path / "workloads" / f"{name}.json").read_text())
    cell["config"] = "refbox_dropped"
    (tmp_path / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "jobs_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.jobs))\n")
    bench = harness.load_benchmark()
    bench["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "driver", "moves": "mlups",
                               "workloads": [name]})
    import time

    res = harness.run(name, 77, 0.2, True, time.perf_counter(), device="cpu",
                      roots=(tmp_path, cells.HERE), bench=bench)
    assert res["correct"]
    assert res["metrics"]["jobs_in_window"]["value"] >= 1
    assert res["metrics"]["jobs_in_window"]["unit"] == "jobs"


def test_same_seed_same_inputs():
    cell, config = cells.load_cell("sweep128.omega64")
    kind = cells.kind(cell)
    a = kind.inputs(cell["traffic"], config, 2**31 + 99)
    b = kind.inputs(cell["traffic"], config, 2**31 + 99)
    c = kind.inputs(cell["traffic"], config, 2**31 + 100)
    assert (a.omegas == b.omegas).all() and not (a.omegas == c.omegas).all()
    assert a.omegas.size == 64 and 1.3 <= a.omegas.min() and a.omegas.max() <= 1.9
