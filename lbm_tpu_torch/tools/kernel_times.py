"""Time the CUDA kernels and the torch twin on the card.

For each grid (a closed box with the reference scenes' parameters,
tools/bench.make_scene): K1 as a loop of launches, K2 and K3 in 256-step
chunks, the int16 kernels K1-i16 and K3-i16, and the plain versions (the
twin, and its int16 form), each run from rest and timed with CUDA events
over repeated calls after a warm call.  Grids up to 1024^2 time every
kernel; larger grids, where the program runs a K1 loop, time K1, the twin
and the int16 ones.  Prints microseconds per step (median and quartiles),
MLUPS, and the computed traffic rate (73 B per cell-step in f32, 37 B in
int16), next to the bandwidth of a 1 GiB device copy measured in the same
process, and the card's name and power limit::

    python -m lbm_tpu_torch.tools.kernel_times [--grids 128,256,512,1024,1536] [--repeats 7]

Needs a CUDA device; without one it exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys

BYTES_PER_CELL_STEP = 2 * 9 * 4 + 1  # f32 state read + written, obstacle byte
BYTES_PER_CELL_STEP_I16 = 2 * 9 * 2 + 1

F32_KERNELS = ("K1", "K2", "K3", "twin")
LARGE_F32_KERNELS = ("K1", "twin")  # above 1024^2, where the program runs K1
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


def format_grid(n: int, times: dict[str, tuple[float, float, float]]) -> str:
    parts = []
    for name, (med, q1, q3) in times.items():
        nbytes = BYTES_PER_CELL_STEP_I16 if name.endswith("-i16") else BYTES_PER_CELL_STEP
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
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("Error: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    med, q1, q3 = copy_gbps(device, args.repeats)
    print(f"copy 1 GiB: {med:.1f} GB/s [{q1:.1f}, {q3:.1f}] | {card}")
    for n in (int(g) for g in args.grids.split(",")):
        print(format_grid(n, time_grid(n, device, args.repeats)) + f" | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
