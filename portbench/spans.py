"""The program's own phase ranges in a traced run's Chrome trace.

While a profiler records, ``lbm_tpu_torch``'s ``PhaseTimer``
(``lbm_tpu_torch/utils/timing.py``) marks each phase of a call with a
``torch.profiler`` range: ``lbm.init``, ``lbm.compute`` and ``lbm.collate``
inside ``lbm.run_simulation`` or ``lbm.run_ensemble``.  They are host
annotations of the traced jobs' trace (``harness.TRACE_PATH``), on the
clock of its device events.  A job owns the ranges that lie inside its
``portbench.job`` annotation; a range outside every job is no job's.  A
program that keeps no such ranges gives none, and the readers built on
this module (``metrics/collate_ms.py``, ``ensemble_init_ms.py``,
``compute_idle_pct.py``) find nothing to read.
"""

from __future__ import annotations

import json
import statistics

from portbench import stats, trace

PREFIX = "lbm."


def load(path) -> list:
    """The complete events of the Chrome trace at ``path``."""
    with open(path) as fp:
        events = json.load(fp).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def by_job(events: list) -> list[dict[str, list[tuple[float, float]]]]:
    """For each job of the trace, in order, the program's ranges inside it:
    {name without the prefix: [(start, end) in us]}."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    jobs = sorted((e["ts"], e["ts"] + e["dur"]) for e in notes if e["name"] == trace.JOB)
    out = [{} for _ in jobs]
    for e in notes:
        if not e["name"].startswith(PREFIX):
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        for i, (lo, hi) in enumerate(jobs):
            if lo <= a and b <= hi:
                out[i].setdefault(e["name"][len(PREFIX):], []).append((a, b))
                break
    return out


def inside(spans, outer) -> list[tuple[float, float]]:
    """The spans that lie inside one of ``outer``."""
    return [(a, b) for a, b in spans if any(lo <= a and b <= hi for lo, hi in outer)]


def median_ms(per_job) -> float | None:
    """The median over the jobs that have any of their summed lengths, in ms."""
    sums = [sum(b - a for a, b in spans) for spans in per_job if spans]
    return 1e-3 * statistics.median(sums) if sums else None


def idle_pct(spans, device) -> float | None:
    """100 x (1 - the union of the device operations (name, cat, start, end)
    clipped to each span, over the spans' summed length); None without a
    span or a device operation."""
    length = sum(b - a for a, b in spans)
    if length <= 0 or not device:
        return None
    busy = sum(stats.union_seconds([(max(s, a), min(e, b)) for _, _, s, e in device
                                    if s < b and e > a]) for a, b in spans)
    return 100.0 * (1.0 - busy * 1e6 / length)
