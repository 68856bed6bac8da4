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

For each grid of ``--shards`` (n x n over 4 row shards, the sharded
modes' layout): K1-slab, K1-slab-i16 and K6 (k = 2, 8, where the shard fits
its L2 budget) on the shard that holds the driven row, in turns, and their
plain versions.

For each shard of ``--ca`` (rows x columns, the last of 4 row shards of a
closed box of 4 x rows x columns, the one that holds the driven row): the
ca engines K4-slab, K7 and K8 at each depth of ``--ca-depths``, f32 and
int16 (K7 f32 only), each where it maps, K8 also split into sub-slabs
(``--ca-parts``), in turns, with frozen ghosts; then the plain ca sweep.

For each grid of ``--hbm``: K9 (the HBM-parts sweep) against K4 at each
depth of ``--ca-depths``, in turns with K1.

For each grid of ``--blocked``: K10 (the two-copy row-block kernel) at each
row-block height of ``--blocked-rows``, in turns with K2 where it maps (to
768^2), else with K3 and K4 at K = 4, and K10's plain version.

``--policy`` times, in turns, K2 against K3 at 128^2, 256^2 and 512^2 and
K1-i16 against K3-i16 at 1024^2: the questions behind the program's L2
budgets.

Prints microseconds per step (median and quartiles), MLUPS, and the
computed traffic rate of a one-step kernel (73 B per cell-step in f32, 37 B
in int16), next to the bandwidth of a 1 GiB device copy measured in the same
process, and the card's name and power limit::

    python -m lbm_tpu_torch.tools.kernel_times [--grids 128,256,512,1024,1536] \
        [--sweeps 1536,2048,4096] [--depths 2,4,8] [--shards 1024,4096] \
        [--ca 64x1024,256x1024,1024x4096] [--ca-depths 4,8] [--ca-parts 1,2,4,8,16] \
        [--hbm 2048,4096] [--blocked 256,512,768,1024] [--blocked-rows 8] [--policy] \
        [--repeats 7]

Needs a CUDA device; without one it exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys

BYTES_PER_CELL_STEP = 2 * 9 * 4 + 1  # f32 state read + written, obstacle byte
BYTES_PER_CELL_STEP_I16 = 2 * 9 * 2 + 1

# Operations of one fluid cell-step, counted from lbm_collide()
# (csrc/lbm_common.cuh): moments 23 (rho 8, u_x and u_y 6 each with the
# division, u_sq 3), equilibria 40 (1.5 u_sq, three w*rho, base, d0, and
# 8 + 8 + 9 + 9 for the four pairs), relaxation 27 (3 per speed), |u| 2
# (sqrt, the sum).  int16 adds its codec: 9 decodes (multiply, add) and 9
# encodes (subtract, multiply, round).  Walls only move values.
OPS_PER_CELL_STEP = 92
OPS_CODEC_I16 = 45
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound_ms(cells: int, fluid: int, steps: int, storage: str = "f32",
             extra_bytes: int = 0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of a launch that reads a state of
    ``cells`` cells once and writes it once, with its obstacle byte per cell
    and ``extra_bytes`` more input (ghost rows), and advances its ``fluid``
    fluid cells ``steps`` steps: the larger of the bytes over the published
    memory rate and the operations over the published float32 rate."""
    nbytes = cells * (BYTES_PER_CELL_STEP_I16 if storage == "i16" else BYTES_PER_CELL_STEP)
    ops = fluid * steps * (OPS_PER_CELL_STEP + (OPS_CODEC_I16 if storage == "i16" else 0))
    t_bytes = (nbytes + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """(median, q1, q3) GB/s of a device-to-device copy of ``nbytes``, read
    + write counted.  1 GiB gives the device-memory rate.  A 16 MiB copy,
    whose source and destination fit the 50 MB L2 together, is what the L2
    rate would be read from, but torch's copy reads no faster there than
    from device memory (PERF.md, section 7): it gives no L2 rate."""
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


def time_shard(n: int, device, shards: int = 4, chunks=(2, 8), repeats: int = 5,
               storages=("f32", "i16")) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of the sharded modes' kernels on the last
    shard of an n x n closed box over ``shards`` row shards (the one that
    holds the driven row), from rest: K1-slab (and K1-slab-i16) as a loop of
    launches, and K6 at each chunk length of ``chunks`` where the shard fits
    its L2 budget, in turns; then their plain versions, the plain slab step
    (``plain-slab``, ``plain-slab-i16``) and K6's (``plain K6 k=2``)."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, ghosted_cuda, quant
    from lbm_tpu_torch.parallel import modes
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    nloc, r = n // shards, shards - 1
    ob = torch.from_numpy(modes._extended_obstacle_slabs(scene.obstacles, shards)[r]).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, nloc + 2, n, device)
    steps = 16 * max(1, 2**26 // (16 * nloc * n))  # a multiple of 2 x 8; ~2^26 cell-steps
    runs, plain = {}, {}
    for storage in storages:
        sfx = "-i16" if storage == "i16" else ""
        x = quant.quantize(f0, p.density) if storage == "i16" else f0
        a, lo, hi = x[:, 1:-1].contiguous(), x[:, :1].clone(), x[:, -1:].clone()
        b = torch.empty_like(a)
        tots = torch.empty(steps, dtype=torch.float32, device=device)
        ab = fused_cuda.bind_slab_step(p, a, lo, hi, ob, b, tots, r * nloc, storage)
        ba = fused_cuda.bind_slab_step(p, b, lo, hi, ob, a, tots, r * nloc, storage)

        def run_slab(_, ab=ab, ba=ba):
            for t in range(0, steps, 2):
                ab(t)
                ba(t + 1)

        runs[f"K1-slab{sfx}"] = (run_slab, None, steps)
        plain[f"plain-slab{sfx}"] = (
            lambda a=a, lo=lo, hi=hi, storage=storage:
                fused_cuda.slab_plain(a, lo, hi, ob, p, r * nloc, storage), 1)
        if storage == "f32" and ghosted_cuda.supports_shard(nloc, n):
            for k in chunks:
                fwd = ghosted_cuda.bind_chunk(p, a, lo, hi, ob, b, tots, r * nloc, k)
                bwd = ghosted_cuda.bind_chunk(p, b, lo, hi, ob, a, tots, r * nloc, k)

                def run_k6(_, fwd=fwd, bwd=bwd, k=k):
                    for t in range(0, steps, 2 * k):
                        fwd(t)
                        bwd(t + k)

                runs[f"K6 k={k}"] = (run_k6, None, steps)
            plain["plain K6 k=2"] = (
                lambda a=a, lo=lo, hi=hi: ghosted_cuda.chunk_plain(a, lo, hi, ob, p, r * nloc, 2),
                2)
    out = time_in_turns(runs, repeats)
    for name, (fn, k) in plain.items():
        med, q1, q3 = _quartiles(_timed_ms(fn, min(repeats, 3)))
        out[name] = (med * 1e3 / k, q1 * 1e3 / k, q3 * 1e3 / k)
    return out


def ca_shard(nloc: int, nx: int, K: int, device, shards: int = 4, storage: str = "f32"):
    """(params, lo, body, hi, obst_ext, row_offset, ny) of the last of
    ``shards`` row shards of a closed box of shards x nloc rows and nx
    columns, from rest: the ca engines' inputs at depth K."""
    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import quant
    from lbm_tpu_torch.parallel import modes
    from lbm_tpu_torch.tools.bench import make_scene

    ny = shards * nloc
    scene = make_scene(f"{nx}x{ny}")
    p = scene.params
    r = shards - 1
    ob = torch_from(modes._extended_obstacle_slabs(scene.obstacles, shards, K)[r], device)
    x = lattice.equilibrium_rest_device(p.density, nloc + 2 * K, nx, device)
    if storage == "i16":
        x = quant.quantize(x, p.density)
    return (p, x[:, :K].clone(), x[:, K:K + nloc].contiguous(), x[:, K + nloc:].clone(), ob,
            r * nloc, ny)


def torch_from(a, device):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def time_ca(nloc: int, nx: int, device, depths=(4, 8), parts=(1, 2, 4, 8, 16), repeats: int = 5,
            storages=("f32", "i16")) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of the ca engines on the last of 4 row
    shards of nloc x nx (see :func:`ca_shard`): ``K4-slab K=4``,
    ``K7 K=4``, ``K8 K=4`` (``K8 K=4 parts=2`` split), ``-i16`` appended for
    int16, each where it maps (K8 unsplit only where the whole shard fits L2,
    split counts that ``ca_cuda.parts_valid`` allows and that leave at least
    as many sub-slabs as the planner's), in turns per storage and depth,
    ghosts frozen; then the plain ca sweep (``plain K=4``)."""
    import torch

    from lbm_tpu_torch.ops import ca_cuda, fused_torch, temporal_cuda

    out = {}
    for storage in storages:
        sfx = "-i16" if storage == "i16" else ""
        for K in depths:
            p, lo, a, hi, ob, off, ny = ca_shard(nloc, nx, K, device, storage=storage)
            b = torch.empty_like(a)
            sweeps = 2 * max(1, 2**27 // (2 * K * nloc * nx))  # ~2^27 cell-steps, even
            steps = sweeps * K
            tots = torch.empty(steps, dtype=torch.float32, device=device)
            engines = []
            if temporal_cuda.supports_shard(nloc, nx, K):
                engines.append(("K4-slab", "slab", 1))
            if storage == "f32" and ca_cuda.supports_resident(nloc, nx, K):
                engines.append(("K7", "resident", 1))
            least = ca_cuda.inplace_parts(nloc, nx, K, ny, storage)
            for n in parts:
                if least is not None and n >= least and ca_cuda.parts_valid(nloc, nx, K, ny, n):
                    engines.append(("K8", "inplace", n))
            runs = {}
            for name, engine, n in engines:
                fwd = ca_cuda.bind_sweep(engine, p, lo, a, hi, ob, b, tots, off, ny, storage, n)
                bwd = ca_cuda.bind_sweep(engine, p, lo, b, hi, ob, a, tots, off, ny, storage, n)

                def run(_, fwd=fwd, bwd=bwd, K=K):
                    for t in range(0, steps, 2 * K):
                        for launch in fwd:
                            launch(t)
                        for launch in bwd:
                            launch(t + K)

                runs[f"{name}{sfx} K={K}" + (f" parts={n}" if n > 1 else "")] = (run, None, steps)
            out.update(time_in_turns(runs, repeats))
            med, q1, q3 = _quartiles(_timed_ms(
                lambda: fused_torch.ca_sweep(lo, a, hi, ob, p, off, ny, storage,
                                             "sweep" if storage == "f32" else "step"),
                min(repeats, 3)))
            out[f"plain{sfx} K={K}"] = (med * 1e3 / K, q1 * 1e3 / K, q3 * 1e3 / K)
    return out


def time_hbm(n: int, device, depths=(4, 8), repeats: int = 5) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of K1, and of K4 and K9 at each depth, in
    turns, on an n x n closed box from rest."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, hbm_cuda, temporal_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    steps = 8 * max(1, 2**27 // (n * n))
    runs = {"K1": (fused_cuda.make_run_all(p, obst, steps), f0, steps)}
    for K in depths:
        runs[f"K4 K={K}"] = (temporal_cuda.make_run_all(p, obst, steps, K), f0, steps)
        if hbm_cuda.supports(p, K):
            runs[f"K9 K={K}"] = (hbm_cuda.make_run_all(p, obst, steps, K), f0, steps)
    return time_in_turns(runs, repeats)


def time_blocked(n: int, device, repeats: int = 7, block_rows=(8,),
                 steps: int = 2048) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of K10 (256-step launches, each row-block
    height of ``block_rows``: ``K10 B=8``, ...) in turns with the kernel
    the policy would otherwise give the grid: K2 where two copies fit its
    L2 budget (to 768^2), else K3 and K4 at K = 4 (1024^2); then K10's plain
    version (``plain K10``, 8 steps) on an n x n closed box from rest."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import blocked_cuda, inplace_cuda, resident_cuda, temporal_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    runs = {f"K10 B={b}": (blocked_cuda.make_run_all(p, obst, steps, block_rows=b), f0, steps)
            for b in block_rows}
    if resident_cuda.fits_l2(n, n):
        runs["K2"] = (resident_cuda.make_run_all(p, obst, steps), f0, steps)
    else:
        if inplace_cuda.fits_l2(n, n):
            runs["K3"] = (inplace_cuda.make_run_all(p, obst, steps), f0, steps)
        if temporal_cuda.supports(p, 4):
            runs["K4 K=4"] = (temporal_cuda.make_run_all(p, obst, steps, 4), f0, steps)
    out = time_in_turns(runs, repeats)
    del runs
    plain_steps = 8
    med, q1, q3 = _quartiles(_timed_ms(
        lambda: blocked_cuda.run_plain(f0, obst, p, plain_steps), min(repeats, 3)))
    out["plain K10"] = (med * 1e3 / plain_steps, q1 * 1e3 / plain_steps, q3 * 1e3 / plain_steps)
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


def format_ca(nloc: int, nx: int, times: dict[str, tuple[float, float, float]]) -> str:
    cells = nloc * nx
    return f"ca shard {nloc}x{nx}: " + " | ".join(
        f"{name} {med:.3f} us/step [{q1:.3f}, {q3:.3f}] {cells / med:.0f} MLUPS"
        for name, (med, q1, q3) in times.items())


def format_shard(n: int, times: dict[str, tuple[float, float, float]], shards: int = 4) -> str:
    cells = (n // shards) * n
    return f"{n}^2/{shards} shard {n // shards}x{n}: " + " | ".join(
        f"{name} {med:.3f} us/step [{q1:.3f}, {q3:.3f}] {cells / med:.0f} MLUPS"
        for name, (med, q1, q3) in times.items())


def main(argv: list[str] | None = None) -> int:
    import torch

    from lbm_tpu_torch.tools.bench import card_line

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grids", default="128,256,512,1024,1536")
    parser.add_argument("--sweeps", default="", help="grids to time K4/K5 on, e.g. 2048,4096")
    parser.add_argument("--depths", default="2,4,8")
    parser.add_argument("--shards", default="", help="grids to time the shard kernels on")
    parser.add_argument("--ca", default="", help="shards to time the ca engines on, e.g. "
                        "64x1024,256x1024,1024x4096 (rows x columns)")
    parser.add_argument("--ca-depths", default="4,8")
    parser.add_argument("--ca-parts", default="1,2,4,8,16")
    parser.add_argument("--hbm", default="", help="grids to time K9 against K4 on")
    parser.add_argument("--blocked", default="", help="grids to time K10 against the policy's "
                        "kernel on, e.g. 256,512,768,1024")
    parser.add_argument("--blocked-rows", default="8",
                        help="K10 row-block heights to time, e.g. 4,8,16")
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
    for n in (int(g) for g in args.shards.split(",") if g):
        print(format_shard(n, time_shard(n, device, repeats=args.repeats)) + f" | {card}")
    ca_depths = tuple(int(k) for k in args.ca_depths.split(","))
    ca_parts = tuple(int(k) for k in args.ca_parts.split(","))
    for shard in (s for s in args.ca.split(",") if s):
        nloc, nx = (int(v) for v in shard.split("x"))
        print(format_ca(nloc, nx, time_ca(nloc, nx, device, ca_depths, ca_parts, args.repeats))
              + f" | {card}")
    for n in (int(g) for g in args.hbm.split(",") if g):
        print(format_grid(n, time_hbm(n, device, ca_depths, args.repeats)) + f" | {card}")
    rows = tuple(int(b) for b in args.blocked_rows.split(","))
    for n in (int(g) for g in args.blocked.split(",") if g):
        print("in turns " + format_grid(n, time_blocked(n, device, args.repeats, rows))
              + f" | {card}")
    if args.policy:
        for n, times in time_policy(device, args.repeats).items():
            print("in turns " + format_grid(n, times) + f" | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
