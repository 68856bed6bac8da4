"""The program's temporal sweeps in a traced run, and the least time of one.

While a profiler records, ``lbm_tpu_torch``'s sweep runners
(``ops/temporal_cuda.py``, K4 and K5; ``ops/hbm_cuda.py``, K9) mark a
call's whole K-step sweeps with the range ``lbm.sweeps.k<K>`` and its K1
remainder with ``lbm.tail``, inside ``lbm.compute``.  A kernel belongs to a
sweeps range when the host call that launched it (a ``cuda_runtime`` or
``cuda_driver`` event) lies inside the range: the launch and the kernel
share the trace's correlation id (``args.correlation``).  The kernel may run
on after the range has closed; no kernel is matched by its name.  K is read
from the range's name.  A program that keeps no such ranges gives none, and
the readers built on this module (``metrics/sweeps_us_per_step.py``,
``metrics/sweeps_roofline.py``) find nothing to read.

The least time of one K-step sweep is the larger of two bounds:

- operations: 92 a fluid cell-step (``portbench.roofline``), K steps, over
  the float32 rate outside the tensor cores;
- bytes: one read and one write of the part of a state copy that the L2
  cannot hold, ``2 x max(0, state bytes - L2 bytes)``, over the memory
  rate.

Leaving the L2's share out makes a bound that no sweep can beat, even one
that keeps part of the state in L2 from one sweep to the next, so the
share of it cannot pass 100%.  It is a bound on any sweep of the state, not
on a kernel as built: a kernel that also streams the wall mask and halos
(K5's own bound, state and mask with no L2 share) spends more.
"""

from __future__ import annotations

import re

from portbench import roofline, spans

# A sweeps range's name after ``spans.PREFIX``.
RANGE = re.compile(r"^sweeps\.k(\d+)$")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# One NVIDIA H100 SXM: 50 MiB of L2 (NVIDIA's data sheet).
L2_BYTES = 50 * 2**20


def by_job(events: list) -> list[tuple[int, float]]:
    """For each traced job with a sweeps range, in order: (K, the summed
    device time in us of the kernels launched inside its sweeps ranges)."""
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
            c = e["args"]["correlation"]
            kernels[c] = kernels.get(c, 0.0) + e["dur"]
    launches = [(e["ts"], e["ts"] + e["dur"], e["args"]["correlation"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})]
    out = []
    for job in spans.by_job(events):
        found = {int(m.group(1)): ranges for name, ranges in job.items()
                 if (m := RANGE.match(name))}
        if not found:
            continue
        if len(found) != 1:
            raise ValueError(f"a job's sweeps ranges name several depths: {sorted(found)}")
        (k, ranges), = found.items()
        ids = {c for a, b, c in launches if spans.inside([(a, b)], ranges)}
        out.append((k, sum(kernels.get(c, 0.0) for c in ids)))
    return out


def steps_swept(work: roofline.Work, k: int) -> int:
    """The steps a job's sweeps advance: all but its K1 tail."""
    return work.steps - work.steps % k


def bound_us(work: roofline.Work, k: int) -> tuple[float, str]:
    """(least us of one K-step sweep of ``work``'s state, "operations" or "bytes")."""
    ops = roofline.OPS_PER_FLUID_CELL_STEP * work.fluid * k * work.instances
    state = 9 * work.cells * work.value_bytes * work.instances
    t_ops = 1e6 * ops / roofline.PEAK_OPS_PER_S
    t_bytes = 1e6 * 2 * max(0, state - L2_BYTES) / roofline.PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
