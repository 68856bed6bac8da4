"""Multi-process launch on one host: the counterpart of ``scripts/run_pod.sh``.

``lbm_tpu``'s pod script runs ``jax.distributed.initialize()`` and then
``run --variant async`` on every host of a TPU pod, and ``--dryrun``
validates the multi-process path with two local CPU processes.  This
launcher starts N ranks of ``python -m lbm_tpu_torch run`` on this host
with the environment ``torchrun`` gives (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
each rank joins the process group (parallel/mesh.py ``join``: its own card
and NCCL where every rank has one, the shared card or the CPU and gloo
otherwise) and steps ``--host-devices`` shards (default 1).  Rank 0 prints
the report and writes the files.

    python -m lbm_tpu_torch.tools.pod --nproc N <params> <obstacles> [run flags]
    python -m lbm_tpu_torch.tools.pod --dryrun [--nproc N] [dist_smoke flags, e.g. --device cpu]

``--variant`` defaults to ``async``, as run_pod.sh:51-53.  ``--dryrun``
runs two (or N) tools/dist_smoke.py workers, each checking the gathered
field bitwise against a one-process run.  A rank that exits non-zero, or
outlives ``--timeout`` seconds, kills the others (their process groups,
so a kernel build they started goes too), and the launcher exits with
that rank's code (124 on the timeout).  ``torchrun`` starts the same ranks
where it is installed.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
ROOT = pathlib.Path(__file__).resolve().parents[2]  # the directory holding the package


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, nproc: int, port: int, extra: dict | None = None) -> dict:
    """This process's environment with ``extra`` and the launcher's
    variables of local rank ``rank`` of ``nproc`` on this host, the package
    importable from any directory."""
    env = dict(os.environ, **(extra or {}))
    env.update(RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(nproc: int, argv: list[str], *, timeout: float | None = None,
           logs: list[str] | None = None, env: dict | None = None,
           cwd: str | None = None) -> int:
    """Start ``nproc`` ranks of ``python <argv>`` with :func:`rank_env`
    (``env``: variables to add), and wait for every one.  ``logs``: a file per rank for its standard output and
    error (default: this process's).  Returns 0 when all exit 0; else the first failed rank's
    code, or 124 when ``timeout`` seconds pass first; the other ranks are
    killed either way, and none is left running."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(nproc):
            out = None
            if logs is not None:
                out = open(logs[r], "w")
                files.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=rank_env(r, nproc, port, env), cwd=cwd, stdout=out,
                stderr=subprocess.STDOUT if out else None, start_new_session=True))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((c for c in codes if c not in (None, 0)), None)
            if failed is not None:
                print(f"pod: a rank exited {failed}; stopping the others", file=sys.stderr)
                return failed
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                print(f"Error: pod: the ranks did not finish within {timeout:g} s",
                      file=sys.stderr)
                return 124
            time.sleep(0.05)
    finally:
        _kill(procs)
        for f in files:
            f.close()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Start N ranks of `python -m lbm_tpu_torch run` on this host",
        usage="%(prog)s --nproc N <params> <obstacles> [run flags] | --dryrun [flags]",
        allow_abbrev=False)
    parser.add_argument("--nproc", type=int, default=None, help="ranks to start")
    parser.add_argument("--dryrun", action="store_true",
                        help="tools/dist_smoke.py workers (--nproc, default 2) instead of a run")
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds the ranks may take before all are killed")
    args, rest = parser.parse_known_args(argv)
    if args.dryrun:
        return launch(args.nproc or 2, ["-m", "lbm_tpu_torch.tools.dist_smoke", *rest],
                      timeout=args.timeout)
    if args.nproc is None or args.nproc < 1 or len(rest) < 2:
        parser.error("give --nproc N (at least 1), the params and the obstacles files")
    if not any(a == "--variant" or a.startswith("--variant=") for a in rest):
        rest = [*rest, "--variant", "async"]  # the stale-halo mode, as run_pod.sh:51-53
    return launch(args.nproc, ["-m", "lbm_tpu_torch", "run", *rest], timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
