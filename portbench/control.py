"""The readings that a cell's correctness limits are set from, at the cell's
own size, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--modes program,i16,bf16]

For each seed it runs the plain reference once in float32 and, for each
mode, one job's outputs judged against it as a run judges them
(``jobs.gaps``): ``program``, one job of the program as the window runs it
(the lower reading); ``i16``, the program with its int16 storage switched
on (the program's own lower-precision path: the scene cells' control);
``bf16``, the reference itself computed in bfloat16 and put in the
program's place; ``bf16s``, the reference with its state rounded to
bfloat16 after every step and its arithmetic in float32 (the control where
the program has no lower-precision path of its own).  Beside the numbers a
run compares, ``where`` gives where the av_vels gaps lie.  One
JSON line a reading goes to standard output.  A benchmark run never runs
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, modes, device: str = "cuda", roots=None):
    """[(mode, {number: reading}, kernel)] of one seed."""
    import torch

    from portbench import cells, jobs

    roots = roots or cells.ROOTS
    cell, config = cells.load_cell(name, roots)
    kind = cells.kind(cell, roots)
    inp = kind.inputs(cell["traffic"], config, seed)
    idx = jobs.sample(inp.instances, cell["traffic"].get("check_instances"), seed)
    ref_f, ref_av = jobs.reference(inp, device, idx)
    out = []
    for mode in modes:
        if mode in ("bf16", "bf16s"):
            f, av = (jobs.reference(inp, device, idx, torch.bfloat16) if mode == "bf16" else
                     jobs.reference(inp, device, idx, store=torch.bfloat16))
            got = jobs.JobOut(f, av, None, f"the reference, {mode}")
            got_idx = np.arange(idx.size)
        else:
            storage = "i16" if mode == "i16" else cell["traffic"].get("storage", "f32")
            got, got_idx = kind.runner(inp, device, storage)(), idx
        seen = {**jobs.gaps(got, ref_f, ref_av, got_idx),
                **where(got.av_vels[:, got_idx], ref_av), "omega_min": float(inp.omegas.min()),
                "omega_max": float(inp.omegas.max())}
        out.append((mode, seen, got.kernel))
    return out


def where(av, ref_av) -> dict:
    """For the look behind ``av_gap``: the step of the worst instance's
    widest av_vels gap (``av_step``), and the widest gap relative to that
    instance's largest av_vels (``av_rel``)."""
    d = np.abs(av.astype(np.float64) - ref_av)
    rel = np.where(np.isfinite(d), d, np.inf) / np.abs(ref_av).max(axis=0)
    b = int(np.argmax(rel.max(axis=0)))
    return {"av_step": int(np.argmax(rel[:, b])), "av_rel": float(rel.max())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--modes", default="program")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for mode, got, kernel in readings(args.workload, seed, args.modes.split(",")):
            print(json.dumps({"cell": args.workload, "seed": seed, "mode": mode,
                              "kernel": kernel, **got}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
