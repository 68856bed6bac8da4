"""Run one cell of the lbm_tpu_torch benchmark on this machine's CUDA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells are ``portbench/workloads/*.json``;
the metrics each reports are listed in ``BENCHMARK.json``.  The last line
of standard output is the result, one JSON object; progress, the kernel the
program's policy took, the window's job count and, last, each number the
correctness check compared beside its limit go to standard error.

The run fails (exit 3, no result) without as many CUDA cards as the cell
asks for: it never falls back to the CPU.  It fails (exit 2, no result)
where the process holds a module of JAX or of the JAX package
(``lbm_tpu``), by top-level name, once the window has closed.  Build and
kernel caches stay under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="the cell, a name in portbench/workloads")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the window's length")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = REPO / "build" / "portbench" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(REPO))
    from portbench import cells, guard, harness

    cell, _ = cells.load_cell(args.workload)
    why_not = guard.missing_cards(cell["chips"])
    if why_not:
        print(f"portbench: {why_not}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; the benchmark measures "
              "lbm_tpu_torch alone", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
