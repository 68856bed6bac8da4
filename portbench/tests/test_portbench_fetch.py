"""``fetch_gbps`` (``portbench/metrics/fetch_gbps.py``) on a synthetic
trace: a job's output bytes over the median of its summed ``lbm.fetch``
ranges inside ``lbm.collate``; None without the ranges or without a trace."""

from __future__ import annotations

import json

import pytest

from portbench import cells, harness, roofline, trace

HOST = "user_annotation"


def x(name, ts, dur, cat=HOST):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def job(t0, fetches, stray=()):
    """A job of 1000 us at ``t0``: its collate from t0 + 800 to t0 + 990,
    the ``lbm.fetch`` ranges (start offset, length) inside it, and ``stray``
    fetch ranges outside it."""
    return [x(trace.JOB, t0, 1000.0), x("lbm.run_simulation", t0 + 5, 990.0),
            x("lbm.compute", t0 + 20, 780.0), x("lbm.host_prepare", t0 + 600, 50.0),
            x("lbm.collate", t0 + 800, 190.0),
            x("Memcpy DtoH (Device -> Pinned)", t0 + 810, 20.0, "gpu_memcpy"),
            *(x("lbm.fetch", t0 + 800 + a, d) for a, d in fetches),
            *(x("lbm.fetch", t0 + a, d) for a, d in stray)]


def synthetic_events():
    """Three jobs whose fetches sum to 60, 100 (and a stray range in compute,
    not counted) and 150 us: the median job fetched for 100 us."""
    return (job(0.0, [(5.0, 50.0), (60.0, 10.0)]) + job(2000.0, [(5.0, 100.0)], [(30.0, 40.0)])
            + job(4000.0, [(5.0, 140.0), (150.0, 10.0)]))


def record(events, path):
    path.write_text(json.dumps({"traceEvents": events}))
    work = roofline.Work(instances=2, cells=1000, fluid=900, steps=500, mask_cells=1000)
    return harness.Record(setup_s=7.0, jobs=[], window_s=1.0, updates_per_job=10**6,
                          work=work, ensemble=False, trace=trace.summarize(events))


def test_bytes_over_the_median_fetch(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    rec = record(synthetic_events(), tmp_path / "trace.json")
    nbytes = 2 * 9 * 1000 * 4 + 500 * 2 * 4
    assert cells.metric("fetch_gbps").read(rec) == pytest.approx(nbytes / 100e-6 / 1e9)


def test_nothing_to_read(tmp_path, monkeypatch):
    """A program with no ``lbm.fetch`` range (the parent's, or a CPU run),
    or a run without a trace, reads None."""
    monkeypatch.setattr(harness, "TRACE_PATH", tmp_path / "trace.json")
    bare = [e for e in synthetic_events() if e["name"] != "lbm.fetch"]
    rec = record(bare, tmp_path / "trace.json")
    assert cells.metric("fetch_gbps").read(rec) is None
    rec = record(synthetic_events(), tmp_path / "trace.json")
    rec.trace = None
    assert cells.metric("fetch_gbps").read(rec) is None
