"""The arithmetic of the numbers, on synthetic readings and traces: the p90,
the idle share, the roofline, the trace's summary and the
metric readers."""

from __future__ import annotations

import statistics

import pytest

from portbench import cells, harness, roofline, stats, trace


def test_percentile():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile([3.0, 1.0, 2.0], 90) == pytest.approx(2.8)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(values, 50) == statistics.median(values)


def test_union_and_gaps():
    iv = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0), (35.0, 36.0)]
    assert stats.union_seconds(iv) == pytest.approx(30e-6)
    assert stats.gaps(iv, -5.0, 50.0) == [(-5.0, 0.0), (20.0, 30.0), (40.0, 50.0)]
    assert stats.gaps(iv, 0.0, 40.0) == [(20.0, 30.0)]


def test_roofline_counts_the_work():
    work = roofline.Work(instances=1, cells=1024 * 1024, fluid=1024 * 1024 - 5114,
                         steps=20000, mask_cells=1024 * 1024)
    least, by = roofline.bound_seconds(work)
    assert by == "operations"
    assert least == pytest.approx(92 * (1024 * 1024 - 5114) * 20000 / 67e12)
    # Charging 73 B a cell-step to device memory would put K3's 21.2 us a
    # step above the peak: that is why those bytes are not compulsory.
    assert 73 * 1024 * 1024 / 3.35e12 > 21.2e-6
    assert work.bytes == 2 * 9 * 4 * 1024 * 1024 + 1024 * 1024 + 4 * 20000


def synthetic_events():
    """Two jobs of 100 us; kernels and a copy; a phase and host operations."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [
        x(trace.JOB, "user_annotation", 1000.0, 100.0),
        x(trace.JOB, "user_annotation", 1150.0, 100.0),
        x(trace.JOB, "gpu_user_annotation", 1000.0, 100.0),
        x(trace.PHASE + "compute", "user_annotation", 1010.0, 80.0),
        x("lbm_inplace_kernel", "kernel", 1010.0, 40.0),
        x("lbm_inplace_kernel", "kernel", 1070.0, 30.0),
        x("lbm_inplace_kernel", "kernel", 1160.0, 60.0),
        x("Memcpy DtoH", "gpu_memcpy", 1230.0, 10.0),
        x("cudaDeviceSynchronize", "cuda_runtime", 1055.0, 10.0),
        x("aten::copy_", "cpu_op", 1100.0, 60.0),
    ]


def test_trace_summary():
    s = trace.summarize(synthetic_events())
    assert s["jobs"] == 2 and s["window_s"] == pytest.approx(250e-6)
    assert s["busy_s"] == pytest.approx(140e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops == pytest.approx({"lbm_inplace_kernel": 130e-6, "Memcpy DtoH": 10e-6})
    idle = dict(s["breakdown"]["idle_gaps"])
    assert idle == pytest.approx({"compute: cudaDeviceSynchronize": 20e-6,
                                  "between_jobs: aten::copy_": 60e-6, "job: python": 30e-6})


def test_readers_on_a_synthetic_record():
    s = trace.summarize(synthetic_events())
    work = roofline.Work(instances=2, cells=100, fluid=90, steps=10, mask_cells=100)
    jobs = [harness.Span(0.0, 1.0, {"init": 0.1, "compute": 0.8, "collate": 0.1}, "K3"),
            harness.Span(1.0, 3.0, {"init": 0.3, "compute": 1.6, "collate": 0.1}, "K3")]
    rec = harness.Record(setup_s=7.0, jobs=jobs, window_s=3.0, updates_per_job=2000,
                         work=work, ensemble=True, trace=s)
    read = lambda name: cells.metric(name).read(rec)  # noqa: E731
    assert read("setup_s") == 7.0
    assert read("mlups") == pytest.approx(4000 / 3.0 / 1e6)
    assert read("job_s_p90") == pytest.approx(1.9)
    assert read("compute_mlups") == pytest.approx(4000 / 2.4 / 1e6)
    assert read("init_ms") == pytest.approx(200.0)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 140 / 250))
    assert read("launches_per_step") == pytest.approx(4 / (10 * 2))
    assert read("ensemble_us_per_instance_step") == pytest.approx(130 / (2 * 10 * 2))
    least, _ = roofline.bound_seconds(work)
    assert read("kernels_roofline") == pytest.approx(100 * least * 2 / 130e-6)
    rec.ensemble, rec.trace = False, None
    for name in ("ensemble_us_per_instance_step", "launches_per_step", "kernels_roofline",
                 "device_idle_pct"):
        assert read(name) is None
    rec.jobs = [harness.Span(0.0, 1.0, None, "K11")]
    assert read("compute_mlups") is None and read("init_ms") is None
