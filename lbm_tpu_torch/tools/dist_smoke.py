"""Multi-process smoke run over torch.distributed.

The counterpart of ``lbm_tpu/tools/dist_smoke.py``: the reference's
flagship configuration is 2 nodes x 40 MPI ranks
(MPI/job_submit_d2q9-bgk:4-6).  Each process joins the process group
(parallel/mesh.py ``join``), holds ``--local-devices`` shards of a closed
box of 8 rows a shard x 128 (``lbm_tpu``'s ca box; tools/dryrun.py's
scene), runs ``--steps`` steps of one discipline, gathers the field, and
checks it, with every step's tot_u, bitwise (``torch.equal``) against a
one-process run of the same program over the same global shards, which
every process builds on its own device.  ``async``'s one-process run is
the same bounded-staleness schedule, so it too is held bitwise.

    python -m lbm_tpu_torch.tools.dist_smoke --process-id 0 --num-processes 2 \\
        --coordinator 127.0.0.1:12421 [--local-devices 4] [--steps 12] \\
        [--mode sync|overlap|async|chunked|ca] [--staleness k] [--storage f32|i16] \\
        [--device cuda|cpu] [--nx 128] [--time-exchange N]

Without ``--process-id``/``--num-processes`` the place comes from the
launcher's environment (tools/pod.py ``--dryrun``, ``torchrun``).  Prints
``DIST_SMOKE_OK process=i/n devices=... mode=... tot_u=...`` and exits 0, or
exits 1 with the mismatch.  A peer that dies or hangs makes every
collective raise within ``--timeout`` seconds.  ``--time-exchange N``
then times the mode's exchange alone (``exchange_us``, this rank's).
"""

from __future__ import annotations

import argparse
import sys
import warnings


def worker(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="distributed smoke worker")
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--coordinator", default="127.0.0.1:12421")
    parser.add_argument("--local-devices", type=int, default=4,
                        help="shards of this process (all on its one device)")
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--mode", default="sync",
                        choices=["sync", "overlap", "async", "chunked", "ca"])
    parser.add_argument("--staleness", type=int, default=None,
                        help="halo age (async), chunk (chunked), depth (ca); default the "
                        "mode's (ca: 2)")
    parser.add_argument("--storage", choices=["f32", "i16"], default="f32")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds a collective waits for its peers")
    parser.add_argument("--nx", type=int, default=128, help="columns of the box")
    parser.add_argument("--time-exchange", type=int, default=0, metavar="N",
                        help="then time N calls of the mode's exchange alone (ring, or ca's K "
                        "rows) on the host's clock, printed as exchange_us")
    args = parser.parse_args(argv)

    import torch

    from lbm_tpu_torch.parallel import mesh as mesh_lib
    from lbm_tpu_torch.parallel import modes
    from lbm_tpu_torch.tools.dryrun import toy_scene

    explicit = args.num_processes is not None
    try:
        proc = mesh_lib.join(args.device, coordinator=args.coordinator if explicit else None,
                             process_id=args.process_id if explicit else None,
                             num_processes=args.num_processes, timeout_s=args.timeout)
    except ValueError as e:  # a refused device or backend
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        n_global = args.local_devices * proc.world
        scene = toy_scene(8 * n_global, args.nx, args.steps)
        staleness = (args.staleness if args.staleness is not None
                     else 2 if args.mode == "ca" else modes.STALENESS_DEFAULTS.get(args.mode, 1))
        meshes = (mesh_lib.make_row_mesh(n_global, [proc.device] * args.local_devices,
                                         proc.rank, proc.world),
                  mesh_lib.make_row_mesh(n_global, [proc.device] * n_global))
        results, runners = [], []
        for mesh in meshes:  # the processes' program, then this process's alone
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # the toy's stale fraction
                prog = modes.build_sharded_program(scene.params, scene.obstacles, mesh,
                                                   args.mode, staleness, storage=args.storage,
                                                   backend="cuda")
            runners.append(prog.make_run_all(args.steps))
            state, tots = runners[-1](prog.init_state)
            results.append((prog.f_of(state).cpu(), tots.cpu(), prog.variant))
        (f, tots, variant), (f_ref, tots_ref, _) = results
        if not (torch.equal(f, f_ref) and torch.equal(tots, tots_ref)):
            print(f"process {proc.rank}: {variant} MISMATCH against one process: max |df| "
                  f"{(f - f_ref).abs().max().item():.3e}, max |dtot_u| "
                  f"{(tots - tots_ref).abs().max().item():.3e}", file=sys.stderr)
            return 1
        timed = (f" exchange_us={_time_exchange(runners[0], args.mode, args.time_exchange):.1f}"
                 if args.time_exchange else "")
        print(f"DIST_SMOKE_OK process={proc.rank}/{proc.world} devices={n_global} "
              f"mode={args.mode} variant={variant} backend={proc.backend} "
              f"tot_u={float(tots[-1]):.6e}{timed}", flush=True)
        return 0
    finally:
        mesh_lib.leave()


def _time_exchange(runner, mode: str, n: int) -> float:
    """Microseconds per call of the runner's own exchange from buffer 0
    (the ring into ghost slot 0, or ca's K rows), its copies and messages
    alone, ``n`` calls between two synchronizations of the device."""
    import time

    import torch
    import torch.distributed as dist

    exchange = runner._ca_ring(0) if mode == "ca" else runner._ring(0, 0)
    devices = [d for d in runner.lay.mesh.distinct if d.type == "cuda"]

    def settle():
        for d in devices:
            torch.cuda.synchronize(d)
        dist.barrier()

    exchange()
    settle()
    t0 = time.perf_counter()
    for _ in range(n):
        exchange()
    settle()
    return (time.perf_counter() - t0) / n * 1e6


if __name__ == "__main__":
    sys.exit(worker())
