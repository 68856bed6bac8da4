"""ensemble_init_ms (ms), layer ensemble: the median over the traced studies
of the ``lbm.init`` range inside ``lbm.run_ensemble`` (``tools/ensemble.py``:
validation, the masks' upload, the rest state, the plan), the ensemble's
counterpart of ``init_ms``; None outside an ensemble cell, without a trace,
or where the program keeps no such range."""

from portbench import harness, spans


def read(rec):
    if rec.trace is None or not rec.ensemble:
        return None
    jobs = spans.by_job(spans.load(harness.TRACE_PATH))
    return spans.median_ms(spans.inside(job.get("init", []), job.get("run_ensemble", []))
                           for job in jobs)
