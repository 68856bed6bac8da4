"""compute_idle_pct (%), layer wrappers: 100 x (1 - the union of the device
operations inside the traced jobs' ``lbm.compute`` ranges over those ranges'
summed length): the launch and host gaps while the program steps, apart
from the idle of init and collate; None without a trace, a device
operation, or such a range."""

from portbench import harness, spans


def read(rec):
    if rec.trace is None:
        return None
    jobs = spans.by_job(spans.load(harness.TRACE_PATH))
    return spans.idle_pct([s for job in jobs for s in job.get("compute", [])],
                          rec.trace["device"])
