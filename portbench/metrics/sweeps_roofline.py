"""sweeps_roofline (%), layer kernels: the least time of the traced jobs'
K-step sweeps (``portbench.sweeps.bound_us``: their operations over the
float32 peak, or one read and one write of the state's share beyond the L2
over the memory peak, whichever is longer, times steps // K a job) over the
device time of the kernels launched inside their ``lbm.sweeps.k<K>``
ranges; None where ``sweeps_us_per_step`` is."""

from portbench import harness, spans, sweeps


def read(rec):
    if rec.trace is None:
        return None
    jobs = sweeps.by_job(spans.load(harness.TRACE_PATH))
    us = sum(t for _, t in jobs)
    least = sum(rec.work.steps // k * sweeps.bound_us(rec.work, k)[0] for k, _ in jobs)
    if us <= 0 or least <= 0:
        return None
    return 100.0 * least / us
