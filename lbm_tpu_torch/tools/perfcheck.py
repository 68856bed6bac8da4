"""Speed gate of the port: ``python -m lbm_tpu_torch.tools.perfcheck``.

The counterpart of ``lbm_tpu/tools/perfcheck.py``.  It runs one quick
``bench`` (``repeats=2``) on one grid per path the default policy launches,
and one ensemble run per ensemble kernel, prints an ``OK`` or ``FAIL``
line each, and exits 1 if any rate falls below its floor or any run took
another program than its row names (the wrong kernel ran).  Each floor is
half an H100 ``bench`` rate recorded in PERF.md (NVIDIA H100 80GB HBM3,
700.00 W, the card and limit of every rate cited below), so the spread
between calls and cards does not give false alarms: it catches "the path
fell off its kernel", not percent-level drift.  No floor comes from a TPU
(``lbm_tpu``'s CHECKS are v5e numbers).  Needs a CUDA card; without one it
exits 1 with ``Error:``.
"""

from __future__ import annotations

import sys
from typing import NamedTuple


class Check(NamedTuple):
    grid: str  # n x n
    storage: str
    steps: int
    rate: float  # the H100 bench rate PERF.md records for this row, MLUPS
    program: str  # the Variant line the run must report (the ensemble: its kernel)
    label: str
    options: dict = {}  # run_bench's sharded options
    instances: int | None = None  # an ensemble of this many instances, not a bench

    @property
    def floor(self) -> float:
        return self.rate / 2


# One row per path the default policy launches (models/program.py for one
# device, lbm_tpu's ca-where-it-maps rule for 4 shards of the card) and per
# ensemble kernel.  The rates: `bench` (and, for the ensemble rows,
# tools/ensemble.py's ensemble_mlups) on NVIDIA H100 80GB HBM3, 700.00 W,
# as PERF.md section 5 records them ("the speed gate's rates"); where two
# runs measured a row, the lower is cited.
CHECKS = [
    # 29428 and 29501 MLUPS (bench x 20000).
    Check("256x256", "f32", 20000, 29428.0, "cuda-resident", "K2, two copies in L2"),
    # 50263 and 50252 MLUPS (bench x 4000).
    Check("1024x1024", "f32", 4000, 50252.0, "cuda-inplace", "K3, in place in L2"),
    # 54987.5 and 54861.2 MLUPS (bench x 2000, after the skewed sweep's redesign).
    Check("2048x2048", "f32", 2000, 54861.2, "cuda-skew", "K5 skewed sweep K=4"),
    # 57968.4 and 57986.4 MLUPS (bench x 400, the same runs).
    Check("4096x4096", "f32", 400, 57968.4, "cuda-skew", "K5 skewed sweep K=4"),
    # 51980 and 52006 MLUPS (bench x 4000).
    Check("1024x1024", "i16", 4000, 51980.0, "cuda-inplace-i16", "K3-i16, in place"),
    # 53521 and 54179 MLUPS (bench x 2000).
    Check("2048x2048", "i16", 2000, 53521.0, "cuda-step-i16", "K1-i16 one-step"),
    # 23855 and 20452 MLUPS (bench x 4000; the host sets its pace, PERF.md section 5).
    Check("1024x1024", "f32", 4000, 20452.0, "ca-8", "ca-8 on K7 over 4 shards",
          {"host_devices": 4}),
    # 23177 and 23499 MLUPS (bench x 4000).
    Check("1024x1024", "i16", 4000, 23177.0, "ca-8-i16", "ca-8-i16 on K8-i16 over 4 shards",
          {"host_devices": 4}),
    # 45723.1 and 45048.7 MLUPS (bench x 400, after the trapezoid sweep's redesign).
    Check("4096x4096", "f32", 400, 45048.7, "ca-4", "ca-4 on K4-slab over 4 shards",
          {"host_devices": 4}),
    # 46608.5 and 46789.7 MLUPS (bench x 400, after the int16 one-step redesign).
    Check("4096x4096", "i16", 400, 46608.5, "sync-i16", "sync-i16 on K1-slab-i16 over 4 shards",
          {"host_devices": 4, "variant": "sync"}),
    # 49862 and 50042 MLUPS (ensemble_mlups x 4000).  K11 does not take
    # it: 16 clusters of 4 of the 30 the card holds at once took 14% more
    # time than K2-batch, as its step model says.
    Check("128x128", "f32", 4000, 49862.0, "K2-batch", "ensemble of 16 on K2-batch",
          instances=16),
    # K11 takes 600 x 64^2 (one block an instance in 5 waves of 132 until
    # its blocks of 512 threads: 2 an instance, 5 waves of 132, two blocks
    # an SM); K1-batch ran it before K11 existed (36799 MLUPS).
    # 81634.5 and 81373.5 MLUPS (ensemble_mlups x 1000).
    Check("64x64", "f32", 1000, 81373.5, "K11", "ensemble of 600 on K11", instances=600),
    # K1-batch runs where K2-batch's groups would get two blocks an instance
    # and no cluster holds one (512^2 x 200).  35553.3 and 35525.6 MLUPS
    # (ensemble_mlups x 200).
    Check("512x512", "f32", 200, 35525.6, "K1-batch", "ensemble of 200 on K1-batch",
          instances=200),
]


def measure(check: Check, repeats: int = 2) -> tuple[float, str]:
    """(MLUPS, program) of one row on the card: ``bench``'s best of
    ``repeats`` runs, or an ensemble of ``check.instances`` closed boxes
    (omegas 1.3 to 1.9) through ``ensemble_mlups``."""
    from lbm_tpu_torch.tools.bench import run_bench

    if check.instances is None:
        r = run_bench(grid=check.grid, steps=check.steps, repeats=repeats,
                      storage=check.storage, **check.options)
        return r["value"], r["variant"]
    import numpy as np

    from lbm_tpu_torch.tools.bench import make_scene
    from lbm_tpu_torch.tools.ensemble import ensemble_mlups

    scene = make_scene(check.grid)
    return ensemble_mlups(scene.params, scene.obstacles, np.linspace(1.3, 1.9, check.instances),
                          num_steps=check.steps, repeats=repeats)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("Error: no CUDA device: the speed gate measures the card", file=sys.stderr)
        return 1
    failures = []
    for check in CHECKS:
        v, program = measure(check)
        ok = v >= check.floor and program == check.program
        print(
            f"{'OK  ' if ok else 'FAIL'} {check.grid:>9s} {check.storage}  "
            f"{v:8.0f} MLUPS  (floor {check.floor:.0f}; {program}; {check.label})",
            flush=True,
        )
        if not ok:
            failures.append(check)
    if failures:
        print(
            f"{len(failures)} path(s) below their regression floor or off their program — "
            "see PERF.md section 5 for the expected rates",
            file=sys.stderr,
        )
        return 1
    print("all kernel paths at speed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
