"""Small cells made from the benchmark's own files, for tests on the CPU."""

from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import cells, harness  # noqa: E402


def small_cell(root: pathlib.Path, base: str, name: str, **traffic) -> str:
    """Write ``root/workloads/<name>.json``: the cell ``base`` with its
    traffic's entries replaced by ``traffic``; returns ``name``."""
    cell, _ = cells.load_cell(base)
    cell = {**cell, "name": name, "traffic": {**cell["traffic"], **traffic}}
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return name


SMALL_SCENE = {"grid": [40, 32], "steps": 200, "trace_jobs": 1}
SMALL_SWEEP = {"grid": [32, 24], "steps": 200, "instances": 6, "trace_jobs": 1}


def run_small(root: pathlib.Path, name: str, traced: bool = False) -> dict:
    """One run of a small cell on the CPU: the chip's look skipped, the rest
    of a run as the benchmark makes it."""
    import time

    return harness.run(name, 2**31 + 12345, 0.2, traced, time.perf_counter(), device="cpu",
                       roots=(root, cells.HERE), bench=harness.load_benchmark())
