"""sweeps_us_per_step (us), layer temporal: the device time of the kernels
launched inside the traced jobs' ``lbm.sweeps.k<K>`` ranges
(``portbench/sweeps.py``), over the steps those ranges advance, steps -
steps mod K a job; None without a trace or where the program keeps no such
range (off the sweep path, or a program without the ranges)."""

from portbench import harness, spans, sweeps


def read(rec):
    if rec.trace is None:
        return None
    jobs = sweeps.by_job(spans.load(harness.TRACE_PATH))
    us = sum(t for _, t in jobs)
    steps = sum(sweeps.steps_swept(rec.work, k) * rec.work.instances for k, _ in jobs)
    if us <= 0 or steps <= 0:
        return None
    return us / steps
