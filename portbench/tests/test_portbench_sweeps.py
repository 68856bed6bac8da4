"""The readers of the program's temporal sweeps (``portbench/sweeps.py``):
``sweeps_us_per_step`` and ``sweeps_roofline`` on a synthetic trace, the
sweep's least time at 2048x2048, and the cell ``refbox.2048``'s files."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.tests.helpers import run_small, small_cell
from portbench import cells, harness, roofline, scene, sweeps, trace

NAMES = ("sweeps_us_per_step", "sweeps_roofline")


def x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_events(k=4):
    """Two jobs of a K-step sweep runner.  In each, two kernels are launched
    inside ``lbm.sweeps.k<K>`` (the second runs on past the range's end)
    and one inside ``lbm.tail`` whose device time lies inside the sweeps
    range's span; every kernel bears the sweep kernel's name.  A kernel
    launched inside a sweeps range outside every job counts for no job."""
    host, rt = "user_annotation", "cuda_runtime"
    ev = []
    for base, c in ((1000.0, 1), (2000.0, 11)):
        ev += [
            x(trace.JOB, host, base, 500.0),
            x("lbm.run_simulation", host, base + 1, 498.0),
            x("lbm.compute", host, base + 10, 400.0),
            x(f"lbm.sweeps.k{k}", host, base + 20, 100.0),
            x("cudaLaunchKernel", rt, base + 30, 5.0, c),
            x("cudaLaunchKernel", rt, base + 60, 5.0, c + 1),
            x("lbm.tail", host, base + 130, 50.0),
            x("cudaLaunchKernel", rt, base + 140, 5.0, c + 2),
            x("lbm_skew_kernel", "kernel", base + 35, 40.0, c),
            x("lbm_skew_kernel", "kernel", base + 100, 60.0, c + 1),
            x("lbm_skew_kernel", "kernel", base + 80, 7.0, c + 2),
            x("Memcpy DtoH", "gpu_memcpy", base + 420, 50.0),
        ]
    ev += [x(f"lbm.sweeps.k{k}", host, 3000.0, 100.0),
           x("cudaLaunchKernel", rt, 3010.0, 5.0, 99),
           x("lbm_skew_kernel", "kernel", 3020.0, 70.0, 99)]
    return ev


def record(events, path, steps=10, cells_=2048 * 2048, fluid=2046 * 2046):
    path.write_text(json.dumps({"traceEvents": events}))
    work = roofline.Work(instances=1, cells=cells_, fluid=fluid, steps=steps, mask_cells=cells_)
    return harness.Record(setup_s=7.0, jobs=[], window_s=1.0, updates_per_job=cells_ * steps,
                          work=work, ensemble=False, trace=trace.summarize(events))


def read(rec):
    return [cells.metric(n).read(rec) for n in NAMES]


@pytest.mark.parametrize("k", [4, 8])
def test_readers_attribute_kernels_by_launch(tmp_path, monkeypatch, k):
    """Two jobs of 10 steps: the sweeps advance 10 - 10 mod K steps a job
    and their kernels took 100 us a job, the tail's 7 us left out."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    rec = record(synthetic_events(k), tmp_path / "trace.json")
    assert sweeps.by_job(synthetic_events(k)) == [(k, 100.0), (k, 100.0)]
    us_per_step, share = read(rec)
    swept = 10 - 10 % k
    assert us_per_step == pytest.approx(200.0 / (2 * swept))
    least = sweeps.bound_us(rec.work, k)[0] * (10 // k) * 2
    assert share == pytest.approx(100.0 * least / 200.0)


def test_a_kernel_without_its_launch_is_no_sweeps(tmp_path, monkeypatch):
    """Attribution rests on the correlation id alone: drop the ids of the
    kernels and nothing is read, whatever their names and times."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    events = [{**e, "args": {}} if e["cat"] == "kernel" else e for e in synthetic_events()]
    assert read(record(events, tmp_path / "trace.json")) == [None, None]


def test_readers_find_nothing_to_read(tmp_path, monkeypatch):
    """A program that keeps no such ranges, or no trace: None."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    bare = [e for e in synthetic_events() if not e["name"].startswith("lbm.")]
    rec = record(bare, tmp_path / "trace.json")
    assert read(rec) == [None, None]
    rec.trace = None
    assert read(rec) == [None, None]


def test_depths_disagree_within_a_job():
    events = synthetic_events(4) + [x("lbm.sweeps.k8", "user_annotation", 1200.0, 10.0)]
    with pytest.raises(ValueError, match="several depths"):
        sweeps.by_job(events)


def test_sweep_bound_at_2048():
    """One read and one write of the 151.0 MB state's share beyond the
    50 MiB L2 over 3.35 TB/s, against K = 4 steps of 2046^2 fluid cells'
    92 operations over 67 TFLOP/s."""
    work = roofline.Work(instances=1, cells=2048 * 2048, fluid=2046 * 2046, steps=8000)
    us, what = sweeps.bound_us(work, 4)
    assert what == "bytes"
    assert us == pytest.approx(2 * (36 * 2048 * 2048 - 52_428_800) / 3.35e12 * 1e6)
    assert us == pytest.approx(58.85, abs=0.005)
    ops = 92 * 2046 * 2046 * 4 / 67e12 * 1e6
    assert ops == pytest.approx(22.99, abs=0.005)
    # A state the L2 holds has no byte bound: the operations are the bound.
    small = roofline.Work(instances=1, cells=1024 * 1024, fluid=1022 * 1022, steps=20000)
    us, what = sweeps.bound_us(small, 4)
    assert what == "operations" and us == pytest.approx(92 * 1022 * 1022 * 4 / 67e12 * 1e6)
    assert sweeps.steps_swept(work, 4) == 8000
    assert sweeps.steps_swept(work._replace(steps=8003), 4) == 8000


def test_refbox_2048_files():
    cell, config = cells.load_cell("refbox.2048")
    traffic = cell["traffic"]
    assert cell["config"] == config["name"] == "box2048" and cell["chips"] == 1
    assert traffic["kind"] == "scene_jobs" and traffic["grid"] == [2048, 2048]
    assert traffic["steps"] == 8000 == config["max_iters"]["2048x2048"]
    assert traffic["storage"] == "f32" and traffic["omega"] == [1.3, 1.9]
    assert traffic["trace_jobs"] == 4
    assert config["reduced"] == ["max_iters"] and "grid" in config["assumed"]
    bench = harness.load_benchmark()
    assert {c["name"]: c for c in bench["configs"]}["box2048"]["reduced"] == ["max_iters"]
    for m in bench["per_layer"]:
        if m["name"] in NAMES:
            assert m["workloads"] == ["refbox.2048"]
    inp = cells.kind(cell).inputs(traffic, config, 2**31 + 4321)
    mask, phys = scene.make(config, (2048, 2048))
    assert np.array_equal(inp.mask, mask) and int((~mask).sum()) == 2046 * 2046
    assert phys == {"density": 0.1, "accel": 0.01, "reynolds_dim": 10}
    assert 1.3 <= inp.omegas[0] <= 1.9 and inp.steps == 8000


def test_small_refbox_2048_runs_correct(tmp_path, monkeypatch):
    """The cell cut to a CPU's size runs correct under its own limits; a
    traced run reports neither reader there (no kernel on the CPU)."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    name = small_cell(tmp_path, "refbox.2048", "small.refbox.2048", grid=[40, 32], steps=203,
                      trace_jobs=1)
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        if "refbox.2048" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [name]
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    res = run_small(tmp_path, name, traced=True)
    assert res["correct"] and res["failed"] == 0
    assert not set(NAMES) & set(res["metrics"])
