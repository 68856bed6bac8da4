"""fetch_gbps (GB/s), layer collate: a job's output bytes, the final
distributions (instances x 9 x cells x 4) and the per-step sums (steps x
instances x 4), over the median over the traced jobs of the summed
``lbm.fetch`` ranges inside the job's ``lbm.collate``
(``lbm_tpu_torch/utils/hostcopy.py``: the outputs' copies through the
page-locked ring into host arrays prepared while the card computed); None
without a trace or where the program keeps no such range."""

from portbench import harness, spans


def read(rec):
    if rec.trace is None:
        return None
    jobs = spans.by_job(spans.load(harness.TRACE_PATH))
    ms = spans.median_ms(spans.inside(job.get("fetch", []), job.get("collate", []))
                         for job in jobs)
    if not ms:
        return None
    w = rec.work
    nbytes = 4 * w.instances * (9 * w.cells + w.steps)
    return nbytes / (1e-3 * ms) / 1e9
