"""collate_ms (ms), layer collate: the median over the traced jobs of the
program's ``lbm.collate`` range (``PhaseTimer``'s "collate", utils/timing.py
of ``lbm_tpu_torch``): the outputs' copies to host memory and the host work
after them; None without a trace or where the program keeps no such range."""

from portbench import harness, spans


def read(rec):
    if rec.trace is None:
        return None
    jobs = spans.by_job(spans.load(harness.TRACE_PATH))
    return spans.median_ms(job.get("collate", []) for job in jobs)
