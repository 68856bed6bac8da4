"""The traced run's record: whole jobs under ``torch.profiler``, and what
the Chrome trace says about the device.

Each job runs inside a ``portbench.job`` annotation.  Where the program's
``models/driver.py`` keeps a ``PhaseTimer`` (``lbm_tpu_torch/utils/timing.py``), its
init / compute / collate phases become ``portbench.phase.<name>``
annotations for the traced jobs, so that an idle stretch of the device can
be put down to the phase it fell in; the phases' arithmetic is the
program's own.  Device operations are the trace's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events; host operations its ``cpu_op``,
``cuda_runtime`` and ``cuda_driver`` events.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os

import numpy as np

from portbench import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
JOB = "portbench.job"
PHASE = "portbench.phase."


@contextlib.contextmanager
def phase_annotations():
    """Annotate the phases of ``models/driver.py``'s timer while the block
    runs (nothing where that module has no ``PhaseTimer`` to annotate)."""
    from torch.profiler import record_function

    from lbm_tpu_torch.models import driver

    base = getattr(driver, "PhaseTimer", None)
    if base is None:
        yield
        return

    class AnnotatedTimer(base):
        def start(self, phase):
            super().start(phase)
            self._annotation = record_function(PHASE + phase)
            self._annotation.__enter__()

        def stop(self, phase):
            self._annotation.__exit__(None, None, None)
            return super().stop(phase)

    driver.PhaseTimer = AnnotatedTimer
    try:
        yield
    finally:
        driver.PhaseTimer = base


def traced_jobs(job, n: int, path) -> tuple[list, list]:
    """Run ``n`` jobs under the profiler; (their outputs, the trace's events).
    The Chrome trace is written to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    outs = []
    with profile(activities=activities) as prof, phase_annotations():
        for _ in range(n):
            with record_function(JOB):
                outs.append(job())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as fp:
        events = json.load(fp).get("traceEvents", [])
    return outs, [e for e in events if e.get("ph") == "X" and "dur" in e]


def summarize(events: list, top: int = 10) -> dict:
    """The traced window's device record: the window (first job's start to
    the last one's end, us), its device operations, busy seconds (their
    union), and the breakdown: the device operations that took most time,
    and the idle stretches summed by where the host was (``<span>: <host
    operation>``, the span a timer phase, ``job`` or
    ``between_jobs``)."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    jobs = [(e["ts"], e["ts"] + e["dur"]) for e in notes if e["name"] == JOB]
    if not jobs:
        raise ValueError("the trace holds no job annotation")
    lo, hi = min(a for a, _ in jobs), max(b for _, b in jobs)
    device = [(e["name"], e["cat"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in DEVICE_CATS and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    intervals = [(max(a, lo), min(b, hi)) for _, _, a, b in device]
    per_op = collections.Counter()
    for name, _, a, b in device:
        per_op[name[:120]] += (b - a) * 1e-6

    phases = [(e["name"][len(PHASE):], e["ts"], e["ts"] + e["dur"]) for e in notes
              if e["name"].startswith(PHASE)]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS]
    h_start = np.array([h[0] for h in host]) if host else np.zeros(0)
    h_end = np.array([h[1] for h in host]) if host else np.zeros(0)
    idle = collections.Counter()
    for a, b in stats.gaps(intervals, lo, hi):
        mid = 0.5 * (a + b)
        span = next((name for name, s, e in phases if s <= mid <= e), None)
        if span is None:
            span = "job" if any(s <= mid <= e for s, e in jobs) else "between_jobs"
        inside = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        what = (host[inside[np.argmin(h_end[inside] - h_start[inside])]][2][:80]
                if inside.size else "python")
        idle[f"{span}: {what}"] += (b - a) * 1e-6
    return {
        "jobs": len(jobs), "window_s": (hi - lo) * 1e-6, "device": device,
        "busy_s": stats.union_seconds(intervals),
        "breakdown": {"device_ops": [[k, v] for k, v in per_op.most_common(top)],
                      "idle_gaps": [[k, v] for k, v in idle.most_common(top)]},
    }
