"""The readers of the program's own phase ranges (``portbench/spans.py``):
``collate_ms``, ``ensemble_init_ms`` and ``compute_idle_pct`` on a
synthetic trace, and on the traces of small traced runs on the CPU."""

from __future__ import annotations

import json

import pytest

from portbench.tests.helpers import SMALL_SCENE, SMALL_SWEEP, run_small, small_cell
from portbench import cells, harness, roofline, spans, trace

PHASES = ("init", "compute", "collate")


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic_events():
    """Two studies of 100 us, each with the program's ranges; in the first
    a gap of 5 us opens each compute range and another lies inside it, and a
    copy runs on past its end; a collate range and a kernel lie outside every job."""
    host = "user_annotation"
    return [
        x(trace.JOB, host, 1000.0, 100.0),
        x("lbm.run_ensemble", host, 1002.0, 96.0),
        x("lbm.init", host, 1005.0, 15.0),
        x("lbm.compute", host, 1020.0, 60.0),
        x("lbm.compute", "gpu_user_annotation", 1025.0, 55.0),
        x("lbm.collate", host, 1080.0, 15.0),
        x("lbm_cluster_batch_kernel", "kernel", 1025.0, 25.0),
        x("lbm_cluster_batch_kernel", "kernel", 1055.0, 25.0),
        x("Memcpy DtoD", "gpu_memcpy", 1075.0, 10.0),
        x("Memcpy DtoH", "gpu_memcpy", 1085.0, 8.0),
        x(trace.JOB, host, 1150.0, 100.0),
        x("lbm.run_ensemble", host, 1152.0, 96.0),
        x("lbm.init", host, 1155.0, 10.0),
        x("lbm.compute", host, 1165.0, 60.0),
        x("lbm.collate", host, 1225.0, 20.0),
        x("lbm_cluster_batch_kernel", "kernel", 1165.0, 60.0),
        x("lbm.collate", host, 1300.0, 100.0),
        x("lbm_cluster_batch_kernel", "kernel", 1300.0, 50.0),
    ]


def record(events, path, ensemble=True):
    path.write_text(json.dumps({"traceEvents": events}))
    work = roofline.Work(instances=2, cells=100, fluid=90, steps=10, mask_cells=100)
    return harness.Record(setup_s=7.0, jobs=[], window_s=1.0, updates_per_job=2000, work=work,
                          ensemble=ensemble, trace=trace.summarize(events))


def test_ranges_by_job():
    jobs = spans.by_job(synthetic_events())
    assert jobs[0] == {"run_ensemble": [(1002.0, 1098.0)], "init": [(1005.0, 1020.0)],
                       "compute": [(1020.0, 1080.0)], "collate": [(1080.0, 1095.0)]}
    assert jobs[1]["collate"] == [(1225.0, 1245.0)] and len(jobs) == 2


def test_readers_on_a_synthetic_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    rec = record(synthetic_events(), tmp_path / "trace.json")
    read = lambda name: cells.metric(name).read(rec)  # noqa: E731
    assert read("collate_ms") == pytest.approx(1e-3 * 17.5)
    assert read("ensemble_init_ms") == pytest.approx(1e-3 * 12.5)
    assert read("compute_idle_pct") == pytest.approx(100 * (1 - 110 / 120))
    rec.ensemble = False
    assert read("ensemble_init_ms") is None and read("collate_ms") is not None


def test_readers_find_nothing_to_read(tmp_path, monkeypatch):
    """No trace, or a program that keeps no ranges: every reader gives None;
    a range with no device operation (a CPU run) gives no idle share."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    events = synthetic_events()
    bare = [e for e in events if not e["name"].startswith(spans.PREFIX)]
    names = ("collate_ms", "ensemble_init_ms", "compute_idle_pct")
    rec = record(bare, tmp_path / "trace.json")
    assert [cells.metric(n).read(rec) for n in names] == [None] * 3
    rec.trace = None
    assert [cells.metric(n).read(rec) for n in names] == [None] * 3
    hostonly = [e for e in events if e["cat"] not in trace.DEVICE_CATS]
    rec = record(hostonly, tmp_path / "trace.json")
    assert cells.metric("compute_idle_pct").read(rec) is None
    assert cells.metric("collate_ms").read(rec) == pytest.approx(1e-3 * 17.5)


@pytest.mark.parametrize("base,traffic", [("refbox.1024", SMALL_SCENE),
                                          ("sweep128.omega64", SMALL_SWEEP)])
def test_traced_small_run_reports_the_ranges(tmp_path, monkeypatch, base, traffic):
    """A traced run on the CPU, reading the metrics of the cell it is cut
    from, reports ``collate_ms`` (and the sweep ``ensemble_init_ms``); each
    job holds one range of each phase in its entry point's, and the
    driver's ``portbench.phase.*`` annotations lie inside the program's own."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    name = small_cell(tmp_path, base, "spans." + base, **traffic)
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        if base in m.get("workloads", [base]):
            m["workloads"] = m.get("workloads", []) + [name]
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    res = run_small(tmp_path, name, traced=True)
    assert res["correct"]
    want = {"collate_ms", "ensemble_init_ms"} if base.startswith("sweep") else {"collate_ms"}
    assert want <= set(res["metrics"]) and "compute_idle_pct" not in res["metrics"]
    events = spans.load(tmp_path / "trace.json")
    jobs = spans.by_job(events)
    entry = "run_ensemble" if base.startswith("sweep") else "run_simulation"
    assert len(jobs) == traffic["trace_jobs"]
    for job in jobs:
        assert sorted(job) == sorted([entry, "init", "compute", "collate"])
        assert all(len(v) == 1 for v in job.values())
        for phase in PHASES:
            assert spans.inside(job[phase], job[entry]) == job[phase]
    if entry == "run_simulation":
        marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == trace.PHASE + "compute"]
        assert len(marks) == len(jobs) and spans.inside(marks, jobs[0]["compute"]) == marks[:1]


def on_the_device_clock(events: list) -> dict:
    """Where a traced run's device operations fall among its jobs' ranges:
    every job holds one entry-point range and one range of each phase
    inside it; every program kernel (``lbm_``) of a job lies inside its
    compute range but for a warm launch inside init; and every copy to the
    host lies inside its collate range.  Returns the counts it checked."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    bounds = sorted((e["ts"], e["ts"] + e["dur"]) for e in notes if e["name"] == trace.JOB)
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    counts = {"jobs": 0, "kernels": 0, "warm": 0, "dtoh": 0}
    for (lo, hi), job in zip(bounds, spans.by_job(events)):
        entry = [k for k in job if k.startswith("run_")]
        assert len(entry) == 1 and all(len(job[k]) == 1 for k in (*entry, *PHASES)), job
        for phase in PHASES:
            assert spans.inside(job[phase], job[entry[0]]) == job[phase]
        ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in device
               if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        kernels = [(a, b) for name, a, b in ops if "lbm_" in name]
        warm = spans.inside(kernels, job["init"])
        assert len(warm) <= 1 and sorted(spans.inside(kernels, job["compute"]) + warm) == \
            sorted(kernels), (job, kernels)
        dtoh = [(a, b) for name, a, b in ops if "DtoH" in name]
        assert len(dtoh) >= 2 and spans.inside(dtoh, job["collate"]) == dtoh, (job, dtoh)
        counts = {"jobs": counts["jobs"] + 1, "kernels": counts["kernels"] + len(kernels),
                  "warm": counts["warm"] + len(warm), "dtoh": counts["dtoh"] + len(dtoh)}
    assert counts["jobs"] == len(bounds) >= 1
    return counts


def test_device_clock_check_on_a_synthetic_trace():
    """The check passes a trace whose jobs keep their kernels in compute and
    their copies to the host in collate, and fails one with a kernel late."""
    events = [e for e in synthetic_events() if e["ts"] < 1300.0]
    events += [x("Memcpy DtoH", "gpu_memcpy", 1094.0, 1.0), x("Memcpy DtoH", "gpu_memcpy",
                                                                1226.0, 9.0),
               x("Memcpy DtoH", "gpu_memcpy", 1236.0, 9.0)]
    assert on_the_device_clock(events) == {"jobs": 2, "kernels": 3, "warm": 0, "dtoh": 4}
    late = events + [x("lbm_cluster_batch_kernel", "kernel", 1230.0, 5.0)]
    with pytest.raises(AssertionError):
        on_the_device_clock(late)


@pytest.mark.cuda
@pytest.mark.parametrize("base,traffic", [
    ("refbox.1024", {"grid": [512, 512], "steps": 2000, "trace_jobs": 2}),
    ("sweep128.omega64", {"steps": 2000, "instances": 16, "trace_jobs": 2})])
def test_ranges_on_the_cards_clock(tmp_path, monkeypatch, base, traffic):
    """On the card the program's ranges share the device operations' clock
    (``on_the_device_clock``), and a traced run reports every per-layer
    metric of its cell."""
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranges are held against CUPTI's device events")
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    name = small_cell(tmp_path, base, "card." + base, **traffic)
    bench = harness.load_benchmark()
    want = [m["name"] for m in harness.cell_metrics(bench, base, True)]
    for m in bench["per_layer"]:
        if m["name"] in want:
            m["workloads"] = m["workloads"] + [name]
    res = harness.run(name, 2**31 + 4321, 1.0, True, time.perf_counter(), device="cuda",
                      roots=(tmp_path, cells.HERE), bench=bench)
    assert res["correct"] and sorted(res["metrics"]) == sorted(want)
    counts = on_the_device_clock(spans.load(tmp_path / "trace.json"))
    assert counts["jobs"] == traffic["trace_jobs"] and counts["kernels"] >= counts["jobs"]
