"""One run of one cell: set-up, the measured window, the traced jobs, the
check against the plain reference, and the result line.

The window is a closed loop with one client, the job queue of one card:
each job starts when the previous one has returned its outputs to the
host, and the window runs whole jobs until ``seconds`` have passed; it
lasts from the first job's start to the last one's end.  Set-up is
everything before it: imports, CUDA's start, the kernel library (built in a
checkout's first run), the inputs, and one untimed job of the cell's own
shape, which loads every kernel the window uses.

A traced run (``trace=True``) then runs the cell's ``trace_jobs`` whole jobs
under the profiler (``portbench/trace.py``); its result line carries the
cell's per-layer metrics, an untraced one its end-to-end metrics.  Either
way, once the window has closed and the peak memory has been read, the
program's state is dropped and the plain reference is run on the same
inputs; every job's outputs are held to it (``portbench/jobs.py``), each
number against the cell's limit.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import sys
import time

from portbench import cells, jobs, trace

REPO = pathlib.Path(__file__).resolve().parents[1]
TRACE_PATH = REPO / "build" / "portbench" / "trace.json"


@dataclasses.dataclass
class Span:
    start: float
    end: float
    phases: dict | None
    kernel: str


@dataclasses.dataclass
class Record:
    """What the metric readers (``metrics/<name>.py``) read."""
    setup_s: float
    jobs: list  # Span of every window job
    window_s: float
    updates_per_job: int  # cells x steps x instances
    work: object  # roofline.Work of one job
    ensemble: bool
    trace: dict | None  # trace.summarize of the traced jobs


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_benchmark(path=REPO / "BENCHMARK.json") -> dict:
    with open(path) as fp:
        return json.load(fp)


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones that
    name it or name no cells; traced, the per-layer ones likewise."""
    return [m for m in bench["per_layer" if traced else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def window(job, seconds: float) -> list:
    """Whole jobs back to back until ``seconds`` have passed: [(Span, JobOut)]."""
    done, t_end = [], time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        out = job()
        t1 = time.perf_counter()
        done.append((Span(t0, t1, out.phases, out.kernel), out))
        if t1 >= t_end:
            return done


def check(outs: list, ref_f, ref_av, idx, limits: dict) -> tuple[dict, int]:
    """({number: its worst reading over the jobs}, jobs that failed)."""
    got = [jobs.gaps(out, ref_f, ref_av, idx) for out in outs]
    failed = sum(any(not g[k] <= limits[k] for k in jobs.CHECKS) for g in got)
    for k in jobs.CHECKS:
        log(f"{k} over {len(got)} jobs: {min(g[k] for g in got)!r} to {max(g[k] for g in got)!r}")
    return {k: max(g[k] for g in got) for k in jobs.CHECKS}, failed


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", roots=cells.ROOTS, bench: dict | None = None) -> dict:
    """The result of one run of the cell ``name``."""
    import torch

    from portbench import roofline

    log(f"set-up: torch imported at {time.perf_counter() - t_start:.3f} s")
    cell, config = cells.load_cell(name, roots)
    kind = cells.kind(cell, roots)
    traffic = cell["traffic"]
    inp = kind.inputs(traffic, config, seed)
    job = kind.runner(inp, device, traffic.get("storage", "f32"))
    log(f"set-up: inputs made at {time.perf_counter() - t_start:.3f} s")
    first = job()
    log(f"kernel: {first.kernel}")
    del first
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    done = window(job, seconds)
    spans = [s for s, _ in done]
    outs = [o for _, o in done]
    window_s = spans[-1].end - spans[0].start
    log(f"window: {len(spans)} jobs in {window_s:.3f} s")
    summary = None
    if traced:
        traced_outs, events = trace.traced_jobs(job, traffic["trace_jobs"], TRACE_PATH)
        outs += traced_outs
        summary = trace.summarize(events)
        log(f"traced: {summary['jobs']} jobs, {len(summary['device'])} device operations in "
            f"{summary['window_s']:.3f} s, busy {summary['busy_s']:.3f} s")
    on_card = device == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del job
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    idx = jobs.sample(inp.instances, traffic.get("check_instances"), seed)
    ref_f, ref_av = jobs.reference(inp, device, idx)
    log(f"reference: {idx.size} of {inp.instances} instances in {time.perf_counter() - t0:.1f} s")
    worst, failed = check(outs, ref_f, ref_av, idx, cell["limits"])

    ny, nx = inp.mask.shape
    work = roofline.Work(instances=inp.instances, cells=nx * ny,
                         fluid=int((~inp.mask).sum()), steps=inp.steps, mask_cells=nx * ny)
    record = Record(setup_s, spans, window_s, nx * ny * inp.steps * inp.instances, work,
                    kind.ENSEMBLE, summary)
    bench = bench if bench is not None else load_benchmark()
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        value = cells.metric(m["name"], roots).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": len(outs), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": worst[k], "limit": cell["limits"][k]} for k in jobs.CHECKS}
    return result
