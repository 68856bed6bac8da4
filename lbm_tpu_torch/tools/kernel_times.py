"""Time the CUDA kernels and the torch twin on the card.

For each grid of ``--grids`` (a closed box with the reference scenes'
parameters, tools/bench.make_scene): K1 as a loop of launches, K2 and K3 in
256-step chunks, the int16 kernels K1-i16 and K3-i16, and the plain versions
(the twin, and its int16 form), each run from rest and timed with CUDA
events over repeated calls after a warm call.  Grids up to 1024^2 time every
kernel; larger grids time K1, the twin and the int16 ones.

For each grid of ``--sweeps`` (grids beyond L2): the sweep kernels K4 and
K5 at each depth of ``--depths``, f32 and int16, timed in turns with K1 /
K1-i16 as the control (every round runs each kernel once, in the reverse
order on odd rounds), and the plain sweep at each depth.

``--policy`` times, in turns, K2 against K3 at 128^2, 256^2 and 512^2 and
K1-i16 against K3-i16 at 1024^2: the questions behind the program's L2
budgets.

Prints microseconds per step (median and quartiles), MLUPS, and the
computed traffic rate of a one-step kernel (73 B per cell-step in f32, 37 B
in int16), next to the bandwidth of a 1 GiB device copy measured in the same
process, and the card's name and power limit::

    python -m lbm_tpu_torch.tools.kernel_times [--grids 128,256,512,1024,1536] \
        [--sweeps 1536,2048,4096] [--depths 2,4,8] [--policy] [--repeats 7]

Needs a CUDA device; without one it exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys

BYTES_PER_CELL_STEP = 2 * 9 * 4 + 1  # f32 state read + written, obstacle byte
BYTES_PER_CELL_STEP_I16 = 2 * 9 * 2 + 1

F32_KERNELS = ("K1", "K2", "K3", "twin")
LARGE_F32_KERNELS = ("K1", "twin")  # above 1024^2 (the sweeps there: time_sweeps)
I16_KERNELS = ("K1-i16", "K3-i16", "twin-i16")


def _timed_ms(fn, repeats: int) -> list[float]:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _quartiles(xs: list[float]) -> tuple[float, float, float]:
    if len(xs) < 2:
        return xs[0], xs[0], xs[0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return statistics.median(xs), q1, q3


def copy_gbps(device, repeats: int = 7, nbytes: int = 2**30) -> tuple[float, float, float]:
    """(median, q1, q3) GB/s of a device-to-device copy, read + write counted."""
    import torch

    a = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    med, q1, q3 = _quartiles(_timed_ms(lambda: b.copy_(a), repeats))
    return 2 * nbytes / med / 1e6, 2 * nbytes / q3 / 1e6, 2 * nbytes / q1 / 1e6


def time_grid(n: int, device, repeats: int = 7) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of every kernel and plain version on an
    n x n grid up to 1024^2; above it, of K1, the twin and the int16 ones."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, fused_torch, inplace_cuda, quant, resident_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    kernels = (F32_KERNELS if n <= 1024 else LARGE_F32_KERNELS) + I16_KERNELS
    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    q0 = quant.quantize(f0, p.density)
    steps = 4000 if n <= 512 else 2000
    twin_steps = 50
    twin_reps = max(1, min(repeats, 5))
    makers = {
        "K1": lambda: (fused_cuda.make_run_all(p, obst, steps), f0, steps, repeats),
        "K2": lambda: (resident_cuda.make_run_all(p, obst, steps), f0, steps, repeats),
        "K3": lambda: (inplace_cuda.make_run_all(p, obst, steps), f0, steps, repeats),
        "K1-i16": lambda: (fused_cuda.make_run_all(p, obst, steps, "i16"), q0, steps, repeats),
        "K3-i16": lambda: (inplace_cuda.make_run_all(p, obst, steps, storage="i16"), q0,
                           steps, repeats),
        "twin": lambda: (lambda f: fused_torch.run_steps(f, obst, p, twin_steps), f0,
                         twin_steps, twin_reps),
        "twin-i16": lambda: (lambda f: fused_torch.run_steps(f, obst, p, twin_steps, "i16"),
                             q0, twin_steps, twin_reps),
    }
    out = {}
    for name in kernels:
        run, start, n_steps, reps = makers[name]()
        med, q1, q3 = _quartiles(_timed_ms(lambda: run(start), reps))
        out[name] = (med * 1e3 / n_steps, q1 * 1e3 / n_steps, q3 * 1e3 / n_steps)
    return out


def time_in_turns(runs: dict, rounds: int) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of each ``name -> (run, start, steps)``,
    each timed once per round after a warm call, in the given order on even
    rounds and reversed on odd ones (A B B A ...), so that a drift of the
    card's clocks falls on all of them alike."""
    import torch

    names = list(runs)
    for name in names:
        run, start, _ = runs[name]
        run(start)
    torch.cuda.synchronize()
    times: dict[str, list[float]] = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            run, start, n_steps = runs[name]
            times[name].append(_timed_ms(lambda: run(start), 1)[0] * 1e3 / n_steps)
    return {name: _quartiles(ts) for name, ts in times.items()}


def time_sweeps(n: int, device, depths=(2, 4, 8), repeats: int = 5,
                storages=("f32", "i16")) -> dict[str, tuple[float, float, float]]:
    """us/step of K1, K4 and K5 at each depth (``K4 K=4``, ...) and of K2
    and K3 where the state fits their L2 budgets, in turns per storage, and
    of the plain sweep at each depth (``plain K=4``; the int16 names end in
    ``-i16``), on an n x n grid."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import (
        fused_cuda,
        fused_torch,
        inplace_cuda,
        quant,
        resident_cuda,
        skew_cuda,
        temporal_cuda,
    )
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    steps = 8 * max(1, 2**27 // (n * n))  # a multiple of 2, 4, 8; ~2^30 cell-steps
    out = {}
    for storage in storages:
        sfx = "-i16" if storage == "i16" else ""
        start = quant.quantize(f0, p.density) if storage == "i16" else f0
        runs = {f"K1{sfx}": (fused_cuda.make_run_all(p, obst, steps, storage), start, steps)}
        if storage == "f32" and resident_cuda.fits_l2(n, n):
            runs["K2"] = (resident_cuda.make_run_all(p, obst, steps), start, steps)
        if inplace_cuda.state_bytes(n, n, storage) <= inplace_cuda.L2_INPLACE_BUDGET:
            runs[f"K3{sfx}"] = (inplace_cuda.make_run_all(p, obst, steps, storage=storage),
                                start, steps)
        for K in depths:
            for name, mod in (("K4", temporal_cuda), ("K5", skew_cuda)):
                runs[f"{name}{sfx} K={K}"] = (mod.make_run_all(p, obst, steps, K, storage),
                                              start, steps)
        out.update(time_in_turns(runs, repeats))
        del runs
        for K in depths:
            med, q1, q3 = _quartiles(_timed_ms(
                lambda: fused_torch.sweep(start, obst, p, K, storage), min(repeats, 3)))
            out[f"plain{sfx} K={K}"] = (med * 1e3 / K, q1 * 1e3 / K, q3 * 1e3 / K)
    return out


def time_policy(device, repeats: int = 7) -> dict[str, dict[str, tuple[float, float, float]]]:
    """The budget questions, each pair timed in turns in one process:
    K2 vs K3 (f32) at 128^2, 256^2, 512^2 and K1-i16 vs K3-i16 at 1024^2."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, inplace_cuda, quant, resident_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    out = {}
    for n in (128, 256, 512, 1024):
        scene = make_scene(f"{n}x{n}")
        p = scene.params
        obst = torch.from_numpy(scene.obstacles).to(device)
        f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
        steps = 4000 if n <= 512 else 2000
        if n <= 512:
            runs = {"K2": (resident_cuda.make_run_all(p, obst, steps), f0, steps),
                    "K3": (inplace_cuda.make_run_all(p, obst, steps), f0, steps)}
        else:
            q0 = quant.quantize(f0, p.density)
            runs = {"K1-i16": (fused_cuda.make_run_all(p, obst, steps, "i16"), q0, steps),
                    "K3-i16": (inplace_cuda.make_run_all(p, obst, steps, storage="i16"), q0,
                               steps)}
        out[n] = time_in_turns(runs, repeats)
    return out


def format_grid(n: int, times: dict[str, tuple[float, float, float]]) -> str:
    parts = []
    for name, (med, q1, q3) in times.items():
        nbytes = BYTES_PER_CELL_STEP_I16 if "-i16" in name else BYTES_PER_CELL_STEP
        parts.append(
            f"{name} {med:.3f} us/step [{q1:.3f}, {q3:.3f}] {n * n / med:.0f} MLUPS "
            f"{nbytes * n * n / med / 1e3:.0f} GB/s"
        )
    return f"{n}^2: " + " | ".join(parts)


def main(argv: list[str] | None = None) -> int:
    import torch

    from lbm_tpu_torch.tools.bench import card_line

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grids", default="128,256,512,1024,1536")
    parser.add_argument("--sweeps", default="", help="grids to time K4/K5 on, e.g. 2048,4096")
    parser.add_argument("--depths", default="2,4,8")
    parser.add_argument("--policy", action="store_true")
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("Error: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    med, q1, q3 = copy_gbps(device, args.repeats)
    print(f"copy 1 GiB: {med:.1f} GB/s [{q1:.1f}, {q3:.1f}] | {card}")
    for n in (int(g) for g in args.grids.split(",") if g):
        print(format_grid(n, time_grid(n, device, args.repeats)) + f" | {card}")
    depths = tuple(int(k) for k in args.depths.split(","))
    for n in (int(g) for g in args.sweeps.split(",") if g):
        print(format_grid(n, time_sweeps(n, device, depths, args.repeats)) + f" | {card}")
    if args.policy:
        for n, times in time_policy(device, args.repeats).items():
            print("in turns " + format_grid(n, times) + f" | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
