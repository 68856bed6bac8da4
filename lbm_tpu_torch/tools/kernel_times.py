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
plain versions.  Each kernel is timed twice: as the sharded modes run it, a
Python loop of bound calls (one per step, or per chunk for K6), which the
host paces on small shards; and card-paced (``K1-slab graph``, ``K6 k=2
graph``), the same loop captured once into a CUDA graph and replayed, so
the time is the card's for its launches.

For each shard of ``--ca`` (rows x columns, the last of 4 row shards of a
closed box of 4 x rows x columns, the one that holds the driven row): the
ca engines K4-slab, K7 and K8 at each depth of ``--ca-depths``, f32 and
int16 (K7 f32 only), each where it maps, K8 also split into sub-slabs
(``--ca-parts``), in turns, with frozen ghosts; then the plain ca sweep.

For each grid of ``--hbm``: K9 (the HBM-parts sweep) against K4 and K5 at
each depth of ``--ca-depths``, in turns with K1, then K9's bounds (its
launch's bytes or operations, and its L2 tier: its parts' cell-steps over
the L2 copy's rate at its slots' working set); ``--hbm-parts 128x2,...``
adds K9 on those part rows and slots (R x S), and ``--hbm-split`` the
split of each K9 timed (no cell, the cells of step 0, of the middle steps,
of the last step: ``SWEEP_SPLIT``).

For each grid of ``--blocked``: K10 (the two-copy row-block kernel) at each
row-block height of ``--blocked-rows``, in turns with K2 where it maps (to
768^2), else with K3 and K4 at K = 4, and K10's plain version.

``--variant NAME=PATH[+PATH...][@RHxRW]`` (repeatable) builds a second kernel
library in which each PATH replaces the package's source of the same file
name (for example the parent commit's, from ``git show
HEAD:lbm_tpu_torch/csrc/inplace.cu``, under the ignored ``build/``), and
times the kernels of the replaced files (and of the sources that include a
replaced header), named ``@NAME``, in turns with the package's own:
``step.cu`` K1 and K1-i16 in ``--grids``, ``--policy`` and as the control of
``--sweeps``, K1-slab and K1-slab-i16 (host- and card-paced) in
``--shards``; ``resident.cu`` K2 in ``--grids`` and ``--policy``;
``ghosted.cu`` K6 (host- and card-paced) in ``--shards``; ``temporal.cu``
K4 in ``--sweeps`` (K5 left out there unless a variant replaces
``skew.cu``; on the package's
regions, ``temporal_cuda.tile``, or on the region RHxRW at every depth) and
K4-slab in ``--ca``; ``skew.cu`` K5 and K5-i16 in ``--sweeps``, beside the
package's K5, K4 and K1 (on the variant's own strips and bands,
``skew_cuda.geometry``: the one-row walk, whose library lacks
``lbm_skew_grid``, on its strips of 64 columns and bands of 128 rows);
``inplace.cu`` K3 and K3-i16 in ``--grids``, ``--sweeps`` and ``--policy``;
``ca_inplace.cu`` K8 and K8-i16 in ``--ca`` (and, with the entry
``lbm_hbm_sweep`` of PRs 5-13, that K9 in ``--hbm``); ``hbm.cu`` K9 in
``--hbm``; ``ca_resident.cu`` K7 in ``--ca``; ``blocked.cu`` K10
at each height of ``--blocked-rows`` in ``--blocked``.
``--k4-regions 48x64,...`` times K4 and K4-slab on compiled regions other
than the table's at each depth (``K4[48x64] K=4``), the same way.

``--ensemble GRID:B[,GRID:B...]`` (n x n grids): the ensemble's kernels
K1-batch, K2-batch (where B groups of blocks can be resident; beyond the
L2 budget its states spill to HBM) and K11 (where one instance fits a
cluster) on B instances of the closed box
(omegas 1.3 to 1.9), in turns with B single runs of the default
single-device kernel (``program.cuda_choice``, one runner per instance's
parameters, run one after the other), in us per instance-step and MLUPS:
the table behind ``ensemble_cuda.kernel_choice``.

``--cluster-forms GRID:B[,GRID:B...]`` times K11 pinned to every block
shape (1024 or 512 threads) and cluster size that maps, in turns with
K2-batch, us per instance-step, beside each form's resident clusters,
waves and modelled step and the plan's pick: the table behind
``ensemble_cuda.cluster_plan``'s constants.
``--cluster-split GRID:B[:C[:THREADS]]`` times K11's split in turns, us a
256-step launch: whole, the band's loads and stores alone, and those with
every step's barriers, carries and sums but no cell (C pins the cluster
size, THREADS the block shape).
``--clusters`` prints the card's resident clusters of each size at the
``--ensemble`` grids' shared memory, and the shared-memory copy's rate
(csrc/smem_copy.cu): K11's tier.

``--l2`` times the L2 copy kernel (csrc/l2_copy.cu: one buffer read and
written in place, pass after pass, in one persistent launch) at the working
sets of K8's 272x1024 f32 slab (9.6 MiB), K3-i16 at 1024^2 (18 MiB) and K3
at 1024^2 (36 MiB), with and without a grid barrier per pass: the rate of
the tier the L2-resident kernels' tier bounds divide by.

``--policy`` times, in turns, K2 against K3 at 128^2, 256^2, 512^2 and
768^2 and K1-i16 against K3-i16 at 512^2, 768^2 and 1024^2: the questions
behind the program's L2 budgets; ``--placements N`` times each pair (and
the kernels of ``--ca`` and ``--blocked``) on N placements of its buffers,
the rounds pooled (a small grid's time moves
with where its buffers land).

Prints microseconds per step (median and quartiles), MLUPS, and the
computed traffic rate of a one-step kernel (73 B per cell-step in f32, 37 B
in int16), next to the bandwidth of a 1 GiB device copy measured in the same
process, and the card's name and power limit::

    python -m lbm_tpu_torch.tools.kernel_times [--grids 128,256,512,1024,1536] \
        [--sweeps 1536,2048,4096] [--depths 2,4,8] [--shards 1024,4096] \
        [--ca 64x1024,256x1024,1024x4096] [--ca-depths 4,8] [--ca-parts 1,2,4,8,16] \
        [--hbm 2048,4096] [--hbm-parts 128x2,256x2] [--hbm-split] \
        [--blocked 256,512,768,1024] [--blocked-rows 8] [--policy] \
        [--placements 5] [--l2] \
        [--ensemble 128:16,128:37,256:8,1024:4] [--cluster-split 256:8,128:16:4] \
        [--cluster-forms 128:64] [--clusters] \
        [--variant parent=build/parent/step.cu] \
        [--k4-regions 48x64] [--repeats 7]

Needs a CUDA device; without one it exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import NamedTuple

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
             extra_bytes: int = 0, mask_cells: int | None = None) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of a launch that reads a state of
    ``cells`` cells once and writes it once, with an obstacle byte for each
    of ``mask_cells`` cells (default ``cells``; an ensemble's shared mask:
    one grid's) and ``extra_bytes`` more input (ghost rows), and advances
    its ``fluid`` fluid cells ``steps`` steps: the larger of the bytes over
    the published memory rate and the operations over the published float32
    rate."""
    per_cell = BYTES_PER_CELL_STEP_I16 if storage == "i16" else BYTES_PER_CELL_STEP
    nbytes = cells * (per_cell - 1) + (cells if mask_cells is None else mask_cells)
    ops = fluid * steps * (OPS_PER_CELL_STEP + (OPS_CODEC_I16 if storage == "i16" else 0))
    t_bytes = (nbytes + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


F32_KERNELS = ("K1", "K2", "K3", "twin")
LARGE_F32_KERNELS = ("K1", "twin")  # above 1024^2 (the sweeps there: time_sweeps)
I16_KERNELS = ("K1-i16", "K3-i16", "twin-i16")


# The L2 copy's working sets: K8's 272x1024 f32 slab (the 256x1024 shard at
# K = 8), K3-i16 and K3 at 1024^2; each one copy of a 9-plane state.
L2_WORKING_SETS = {"9.6 MiB": 9 * 272 * 1024 * 4, "18 MiB": 9 * 1024 * 1024 * 2,
                   "36 MiB": 9 * 1024 * 1024 * 4}
L2_PASSES = 256


class Variant(NamedTuple):
    lib: object  # the library (ctypes.CDLL)
    tile: object  # K -> (tile rows, tile columns) of K4
    files: frozenset  # the package's sources it replaces
    paths: tuple = ()  # (file name, path) of each


def parse_variant(spec: str):
    """``NAME=PATH[+PATH...][@RHxRW]`` -> (NAME, {file name: path}, region
    or None)."""
    import pathlib

    name, rest = spec.split("=", 1)
    region = None
    if "@" in rest:
        rest, shape = rest.rsplit("@", 1)
        region = tuple(int(v) for v in shape.split("x"))
    paths = [pathlib.Path(p) for p in rest.split("+") if p]
    if not name or not paths:
        raise ValueError(f"--variant {spec!r}: want NAME=PATH[+PATH...][@RHxRW]")
    return name, {path.name: path for path in paths}, region


def load_variants(specs) -> dict:
    """``NAME=PATH[+PATH...][@RHxRW]`` -> {NAME: :class:`Variant`}: the
    package's sources with each PATH in place of the source of its name
    (``_build.load_variant``); K4 on the package's regions or on the region
    RHxRW at every depth."""
    from lbm_tpu_torch.ops import _build, temporal_cuda

    out = {}
    for spec in specs or ():
        name, replace, region = parse_variant(spec)
        tile = temporal_cuda.tile
        if region is not None:
            tile = lambda K, rh=region[0], rw=region[1]: (rh - 2 * K, rw - 2 * K)  # noqa: E731
        out[name] = Variant(_build.load_variant(replace), tile, frozenset(replace),
                            tuple(replace.items()))
    return out


def replacing(variants, source: str) -> dict:
    """The variants that replace ``source`` (a file name of csrc/) or a
    header it includes."""
    import re

    from lbm_tpu_torch.ops import _build

    headers = set(re.findall(r'#include "([^"]+)"', (_build.CSRC / source).read_text()))
    headers |= {h2 for h in headers if (_build.CSRC / h).exists()
                for h2 in re.findall(r'#include "([^"]+)"', (_build.CSRC / h).read_text())}
    return {name: v for name, v in (variants or {}).items()
            if source in v.files or headers & v.files}


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
    + write counted.  1 GiB gives the device-memory rate (the L2 tier's is
    :func:`l2_copy_gbps`'s: torch's copy of 16 MiB reads no faster than
    from device memory, PERF.md Findings PR 8)."""
    import torch

    a = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    med, q1, q3 = _quartiles(_timed_ms(lambda: b.copy_(a), repeats))
    return 2 * nbytes / med / 1e6, 2 * nbytes / q3 / 1e6, 2 * nbytes / q1 / 1e6


def l2_copy_gbps(device, nbytes: int, barrier: bool, passes: int = L2_PASSES,
                 repeats: int = 7) -> tuple[float, float, float]:
    """(median, q1, q3) GB/s of the L2 copy kernel (csrc/l2_copy.cu) on one
    buffer of ``nbytes``: ``passes`` in-place passes in one launch, each
    16-byte word read and written once per pass (read + write counted),
    with a grid barrier after every pass when ``barrier``."""
    import torch

    from lbm_tpu_torch.ops import _build, _runner

    lib = _build.load()
    grid = _runner.cooperative_grid(lib, "lbm_l2_copy_grid", "the L2 copy", device)
    buf = torch.zeros(nbytes // 16 * 4, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        _build.check(lib.lbm_l2_copy(buf.data_ptr(), buf.numel() // 4, passes, int(barrier),
                                     grid, stream, device.index), "L2 copy")

    med, q1, q3 = _quartiles(_timed_ms(run, repeats))
    moved = 2 * buf.numel() * 4 * passes
    return moved / med / 1e6, moved / q3 / 1e6, moved / q1 / 1e6


def l2_rates(device, repeats: int = 7) -> dict[str, dict[str, tuple[float, float, float]]]:
    """GB/s (median, q1, q3) of the L2 copy at each of
    :data:`L2_WORKING_SETS`, with (``barrier``) and without (``free``) a
    grid barrier per pass."""
    return {label: {"barrier": l2_copy_gbps(device, nbytes, True, repeats=repeats),
                    "free": l2_copy_gbps(device, nbytes, False, repeats=repeats)}
            for label, nbytes in L2_WORKING_SETS.items()}


def l2_rate_for(rates: dict, nbytes: int) -> tuple[str, float]:
    """(label, GB/s with a barrier per pass) of the smallest measured L2
    working set that holds ``nbytes``, or of the largest: the rate an
    L2-resident kernel's tier bound divides by."""
    fits = [lb for lb, b in L2_WORKING_SETS.items() if b >= nbytes and lb in rates]
    label = min(fits, key=L2_WORKING_SETS.get) if fits else max(rates, key=L2_WORKING_SETS.get)
    return label, rates[label]["barrier"][0]


def format_l2(rates: dict) -> str:
    return "L2 copy GB/s: " + " | ".join(
        f"{label} barrier {r['barrier'][0]:.1f} [{r['barrier'][1]:.1f}, {r['barrier'][2]:.1f}]"
        f" free {r['free'][0]:.1f} [{r['free'][1]:.1f}, {r['free'][2]:.1f}]"
        for label, r in rates.items())


def time_grid(n: int, device, repeats: int = 7,
              variants=None) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of every kernel on an n x n grid up to
    1024^2, in turns, then of the plain versions; above it, of K1, the twin
    and the int16 ones.  Each variant that replaces ``inplace.cu``
    (:func:`load_variants`) adds its K3 and K3-i16 (``K3@NAME``) to the
    turns, each that replaces ``resident.cu`` its K2 where K2 runs, and
    each that replaces ``step.cu`` its K1 and K1-i16."""
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
    runs = {name: makers[name]()[:3] for name in kernels if not name.startswith("twin")}
    for vname, v in replacing(variants, "inplace.cu").items():
        if "K3" in kernels:
            runs[f"K3@{vname}"] = (inplace_cuda.make_run_all(p, obst, steps, lib=v.lib), f0,
                                   steps)
        runs[f"K3-i16@{vname}"] = (inplace_cuda.make_run_all(p, obst, steps, storage="i16",
                                                             lib=v.lib), q0, steps)
    if "K2" in kernels:
        for vname, v in replacing(variants, "resident.cu").items():
            runs[f"K2@{vname}"] = (resident_cuda.make_run_all(p, obst, steps, lib=v.lib), f0,
                                   steps)
    for vname, v in replacing(variants, "step.cu").items():
        runs[f"K1@{vname}"] = (fused_cuda.make_run_all(p, obst, steps, lib=v.lib), f0, steps)
        runs[f"K1-i16@{vname}"] = (fused_cuda.make_run_all(p, obst, steps, "i16", lib=v.lib),
                                   q0, steps)
    out = time_in_turns(runs, repeats)
    del runs
    for name in kernels:
        if name.startswith("twin"):
            run, start, n_steps, reps = makers[name]()
            med, q1, q3 = _quartiles(_timed_ms(lambda: run(start), reps))
            out[name] = (med * 1e3 / n_steps, q1 * 1e3 / n_steps, q3 * 1e3 / n_steps)
    return out


def time_in_turns(runs: dict, rounds: int, raw: bool = False) -> dict:
    """us/step (median, q1, q3) of each ``name -> (run, start, steps)``,
    each timed once per round after a warm call, in the given order on even
    rounds and reversed on odd ones (A B B A ...), so that a drift of the
    card's clocks falls on all of them alike; with ``raw``, each name's
    per-round times."""
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
    return times if raw else {name: _quartiles(ts) for name, ts in times.items()}


def time_placed(make_runs, rounds: int, placements: int) -> dict[str, tuple[float, float, float]]:
    """:func:`time_in_turns` of ``make_runs()``, ``placements`` times over:
    each time on runners built anew while the earlier ones stay allocated,
    so that their buffers land elsewhere in device memory and in L2, and
    each name's rounds pooled over all of them.  A small grid's time can
    move with where its buffers land (K3 by 10% at 256^2, PERF.md Findings
    PR 10); pooled, that spread falls on every kernel alike."""
    keep, pooled = [], {}
    for _ in range(placements):
        keep.append(make_runs())
        for name, ts in time_in_turns(keep[-1], rounds, raw=True).items():
            pooled.setdefault(name, []).extend(ts)
    return {name: _quartiles(ts) for name, ts in pooled.items()}


def time_sweeps(n: int, device, depths=(2, 4, 8), repeats: int = 5,
                storages=("f32", "i16"), variants=None,
                regions=()) -> dict[str, tuple[float, float, float]]:
    """us/step of K1, K4 and K5 at each depth (``K4 K=4``, ...) and of K2
    and K3 where the state fits their L2 budgets, in turns per storage, and
    of the plain sweep at each depth (``plain K=4``; the int16 names end in
    ``-i16``), on an n x n grid.  With ``variants`` (:func:`load_variants`)
    the K4 of each variant that replaces ``temporal.cu`` (``K4@NAME K=4``)
    runs in the same turns, and K5 is left out unless a variant replaces
    ``skew.cu``; so does the K5 of each that replaces ``skew.cu``
    (``K5@NAME K=4``), and the K3 of each
    that replaces ``inplace.cu`` (``K3@NAME``) where K3 maps; with
    ``regions`` ((rows, columns) of compiled regions) so does K4 on each of
    them (``K4[48x64] K=4``); so does the K1 of each variant that replaces
    ``step.cu`` (``K1@NAME``)."""
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
        for vname, v in replacing(variants, "step.cu").items():
            runs[f"K1{sfx}@{vname}"] = (fused_cuda.make_run_all(p, obst, steps, storage,
                                                                lib=v.lib), start, steps)
        if storage == "f32" and resident_cuda.fits_l2(n, n):
            runs["K2"] = (resident_cuda.make_run_all(p, obst, steps), start, steps)
        if inplace_cuda.state_bytes(n, n, storage) <= inplace_cuda.L2_INPLACE_BUDGET:
            runs[f"K3{sfx}"] = (inplace_cuda.make_run_all(p, obst, steps, storage=storage),
                                start, steps)
            for vname, v in replacing(variants, "inplace.cu").items():
                runs[f"K3{sfx}@{vname}"] = (inplace_cuda.make_run_all(
                    p, obst, steps, storage=storage, lib=v.lib), start, steps)
        k4_variants = replacing(variants, "temporal.cu")
        k5_variants = replacing(variants, "skew.cu")
        mods = (("K4", temporal_cuda), ("K5", skew_cuda))
        for K in depths:
            for name, mod in mods[:1 if k4_variants and not k5_variants else 2]:
                runs[f"{name}{sfx} K={K}"] = (mod.make_run_all(p, obst, steps, K, storage),
                                              start, steps)
            for vname, v in k5_variants.items():
                runs[f"K5{sfx}@{vname} K={K}"] = (skew_cuda.make_run_all(
                    p, obst, steps, K, storage, lib=v.lib), start, steps)
            for vname, v in k4_variants.items():
                runs[f"K4{sfx}@{vname} K={K}"] = (temporal_cuda.make_run_all(
                    p, obst, steps, K, storage, tile_hw=v.tile(K), lib=v.lib), start, steps)
            for rh, rw in regions:
                if min(rh, rw) > 2 * K:
                    runs[f"K4{sfx}[{rh}x{rw}] K={K}"] = (temporal_cuda.make_run_all(
                        p, obst, steps, K, storage, tile_hw=(rh - 2 * K, rw - 2 * K)), start,
                        steps)
        out.update(time_in_turns(runs, repeats))
        del runs
        for K in depths:
            med, q1, q3 = _quartiles(_timed_ms(
                lambda: fused_torch.sweep(start, obst, p, K, storage), min(repeats, 3)))
            out[f"plain{sfx} K={K}"] = (med * 1e3 / K, q1 * 1e3 / K, q3 * 1e3 / K)
    return out


def time_shard(n: int, device, shards: int = 4, chunks=(2, 8), repeats: int = 5,
               storages=("f32", "i16"), variants=None) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of the sharded modes' kernels on the last
    shard of an n x n closed box over ``shards`` row shards (the one that
    holds the driven row), from rest: K1-slab (and K1-slab-i16) as a loop of
    launches, and K6 at each chunk length of ``chunks`` where the shard fits
    its L2 budget, in turns, each host-paced (``K1-slab``, ``K6 k=2``: one
    bound call per step or chunk, as the sharded modes make them) and
    card-paced (``K1-slab graph``, ``K6 k=2 graph``: the same calls captured
    once into a CUDA graph and replayed); then their plain versions, the
    plain slab step (``plain-slab``, ``plain-slab-i16``) and K6's (``plain K6
    k=2``).  With ``variants`` (:func:`load_variants`) the K1-slab of each
    that replaces ``step.cu`` (``K1-slab@NAME``, ``K1-slab@NAME graph``) and
    the K6 of each that replaces ``ghosted.cu`` (``K6@NAME k=2``, ...) run
    in the same turns."""
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
    libs = {"": None, **{f"@{vname}": v.lib
                         for vname, v in replacing(variants, "step.cu").items()}}
    k6_libs = {"": None, **{f"@{vname}": v.lib
                            for vname, v in replacing(variants, "ghosted.cu").items()}}
    runs, plain = {}, {}
    buffers = []  # every bound launch reads and writes these by address: keep them
    for storage in storages:
        sfx = "-i16" if storage == "i16" else ""
        x = quant.quantize(f0, p.density) if storage == "i16" else f0
        a, lo, hi = x[:, 1:-1].contiguous(), x[:, :1].clone(), x[:, -1:].clone()
        b = torch.empty_like(a)
        tots = torch.empty(steps, dtype=torch.float32, device=device)
        buffers.append((a, b, lo, hi, tots))
        for tag, lib in libs.items():

            def bind(lib=lib, a=a, b=b, lo=lo, hi=hi, tots=tots, storage=storage):
                ab = fused_cuda.bind_slab_step(p, a, lo, hi, ob, b, tots, r * nloc, storage,
                                               lib=lib)
                ba = fused_cuda.bind_slab_step(p, b, lo, hi, ob, a, tots, r * nloc, storage,
                                               lib=lib)

                def run_slab(_=None):
                    for t in range(0, steps, 2):
                        ab(t)
                        ba(t + 1)

                return run_slab

            runs[f"K1-slab{sfx}{tag}"] = (bind(), None, steps)
            runs[f"K1-slab{sfx}{tag} graph"] = (card_paced(bind, device), None, steps)
        plain[f"plain-slab{sfx}"] = (
            lambda a=a, lo=lo, hi=hi, storage=storage:
                fused_cuda.slab_plain(a, lo, hi, ob, p, r * nloc, storage), 1)
        if storage == "f32" and ghosted_cuda.supports_shard(nloc, n):
            for tag, lib in k6_libs.items():
                for k in chunks:

                    def bind_k6(lib=lib, k=k, a=a, b=b, lo=lo, hi=hi, tots=tots):
                        # Each chunk starts from where the last one left the
                        # state: a launcher from b follows one that ends in b.
                        fwd = ghosted_cuda.bind_chunk(p, a, lo, hi, ob, b, tots, r * nloc, k,
                                                      lib=lib)
                        bwd = ghosted_cuda.bind_chunk(p, b, lo, hi, ob, a, tots, r * nloc, k,
                                                      lib=lib)
                        nxt = bwd if fwd.result is b else fwd

                        def run_k6(_=None):
                            for t in range(0, steps, 2 * k):
                                fwd(t)
                                nxt(t + k)

                        return run_k6

                    runs[f"K6{tag} k={k}"] = (bind_k6(), None, steps)
                    runs[f"K6{tag} k={k} graph"] = (card_paced(bind_k6, device), None, steps)
            plain["plain K6 k=2"] = (
                lambda a=a, lo=lo, hi=hi: ghosted_cuda.chunk_plain(a, lo, hi, ob, p, r * nloc, 2),
                2)
    out = time_in_turns(runs, repeats)
    del runs, buffers
    for name, (fn, k) in plain.items():
        med, q1, q3 = _quartiles(_timed_ms(fn, min(repeats, 3)))
        out[name] = (med * 1e3 / k, q1 * 1e3 / k, q3 * 1e3 / k)
    return out


def card_paced(bind, device):
    """``run(_)`` replaying a CUDA graph of the launch loop that ``bind()``
    returns: the loop's launches with no host call between them.  The loop
    is bound on a stream of its own (the wrappers launch on the stream
    current at binding), run once there to warm, and captured on that
    stream, so that what a binding allocates and copies stays outside the
    graph."""
    import torch

    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        loop = bind()
        loop()  # a warm run outside the capture (builds and loads the library)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        loop()

    def run(_=None, loop=loop):  # the loop keeps its buffers alive with the graph
        graph.replay()

    return run


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
            storages=("f32", "i16"), variants=None, regions=(),
            placements: int = 1) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of the ca engines on the last of 4 row
    shards of nloc x nx (see :func:`ca_shard`): ``K4-slab K=4``,
    ``K7 K=4``, ``K8 K=4`` (``K8 K=4 parts=2`` split), ``-i16`` appended for
    int16, each where it maps (K8 unsplit only where the whole shard fits L2,
    split counts that ``ca_cuda.parts_valid`` allows and that leave at least
    as many sub-slabs as the planner's), in turns per storage and depth,
    ghosts frozen; then the plain ca sweep (``plain K=4``).  With
    ``variants`` (:func:`load_variants`) the K4-slab of each variant that
    replaces ``temporal.cu`` (``K4-slab@NAME K=4``) and the K8 of each that
    replaces ``ca_inplace.cu`` (``K8@NAME K=4``, whole or split as K8) run
    in the same turns, as does the K7 of each that replaces
    ``ca_resident.cu`` (``K7@NAME K=4``), and with ``regions`` K4-slab on
    each of them (``K4-slab[48x64] K=4``).  The turns run on ``placements``
    placements of the engines' buffers (:func:`time_placed`)."""
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
                engines += [(f"K7@{v}", ("resident", v), 1)
                            for v in replacing(variants, "ca_resident.cu")]
            least = ca_cuda.inplace_parts(nloc, nx, K, ny, storage)
            k8_variants = replacing(variants, "ca_inplace.cu")
            for n in parts:
                if least is not None and n >= least and ca_cuda.parts_valid(nloc, nx, K, ny, n):
                    engines.append(("K8", "inplace", n))
                    engines += [(f"K8@{v}", ("inplace", v), n) for v in k8_variants]
            if temporal_cuda.supports_shard(nloc, nx, K):
                engines += [(f"K4-slab@{v}", v, 1) for v in replacing(variants, "temporal.cu")]
                engines += [(f"K4-slab[{rh}x{rw}]", (rh, rw), 1) for rh, rw in regions
                            if min(rh, rw) > 2 * K]

            def make_runs(engines=engines, p=p, lo=lo, a=a, b=b, hi=hi, ob=ob, off=off, ny=ny,
                          tots=tots, steps=steps, K=K, storage=storage, sfx=sfx):
                return {name: run for name, run in _ca_runs(
                    engines, variants, p, lo, a, b, hi, ob, off, ny, tots, steps, K, storage,
                    sfx)}

            out.update(time_placed(make_runs, repeats, placements))
            med, q1, q3 = _quartiles(_timed_ms(
                lambda: fused_torch.ca_sweep(lo, a, hi, ob, p, off, ny, storage,
                                             "sweep" if storage == "f32" else "step"),
                min(repeats, 3)))
            out[f"plain{sfx} K={K}"] = (med * 1e3 / K, q1 * 1e3 / K, q3 * 1e3 / K)
    return out


def _ca_runs(engines, variants, p, lo, a, b, hi, ob, off, ny, tots, steps, K, storage, sfx):
    """The runs of :func:`time_ca`'s turns for one storage and depth: each
    engine's binding of both directions (a -> b, b -> a), as (name, (run,
    None, steps))."""
    from lbm_tpu_torch.ops import ca_cuda, temporal_cuda

    for name, engine, n in engines:
        if isinstance(engine, tuple) and engine[0] in ("inplace", "resident"):
            lib = variants[engine[1]].lib
            fwd, bwd = (ca_cuda.bind_sweep(engine[0], p, lo, x, hi, ob, y, tots, off,
                                           ny, storage, n, lib=lib)
                        for x, y in ((a, b), (b, a)))
        elif engine in (variants or {}) or isinstance(engine, tuple):
            lib, tile = ((variants[engine].lib, variants[engine].tile)
                         if engine in (variants or {}) else
                         (None, lambda K, e=engine: (e[0] - 2 * K, e[1] - 2 * K)))
            fwd, bwd = ([temporal_cuda.bind_slab_sweep(
                p, lo, x, hi, ob, y, tots, off, ny, storage, tile(K), lib)]
                for x, y in ((a, b), (b, a)))
        else:
            fwd = ca_cuda.bind_sweep(engine, p, lo, a, hi, ob, b, tots, off, ny,
                                     storage, n)
            bwd = ca_cuda.bind_sweep(engine, p, lo, b, hi, ob, a, tots, off, ny,
                                     storage, n)

        def run(_, fwd=fwd, bwd=bwd, K=K):
            for t in range(0, steps, 2 * K):
                for launch in fwd:
                    launch(t)
                for launch in bwd:
                    launch(t + K)

        yield (f"{name}{sfx} K={K}" + (f" parts={n}" if n > 1 else ""),
               (run, None, steps))


# The split of K9 (``--hbm --hbm-split``), a sweep on K8's cell walk: the
# kernel with the cells of some steps only, every wait, step sum, launch
# and |u| pass kept.  ``floor`` (no cell) is what a sweep costs
# beyond its cells; ``step0`` minus ``floor`` the first step's (the pull
# from the input rows), ``middle`` minus ``floor`` the in-place steps',
# ``last`` minus ``floor`` the last step's (the write of the body rows).
SWEEP_SPLIT = {"floor": "false", "step0": "t == 0", "middle": "(t > 0 && t + 1 < K)",
               "last": "t + 1 == K"}
_CELL_LOOP = "for (int c0 = c_first; c0 < bd.end; c0 += kC * lbm::kThreads) {"


def split_source(text: str, part: str) -> str:
    """The source ``text`` of a sweep on K8's cell walk (``ca_inplace.cu``,
    ``hbm.cu``) with the cells of the steps of :data:`SWEEP_SPLIT`'s
    ``part`` only."""
    if text.count(_CELL_LOOP) != 1:
        raise ValueError("the source has no single cell loop of K8's walk to split")
    return text.replace(_CELL_LOOP, _CELL_LOOP.replace(
        "c0 < bd.end;", f"({SWEEP_SPLIT[part]}) && c0 < bd.end;"))


def split_libs(name: str, path) -> dict:
    """{part: library} of :data:`SWEEP_SPLIT`: the package's sources with
    the file ``name`` replaced by :func:`split_source` of ``path``, written
    under the ignored build directory."""
    import hashlib
    import pathlib

    from lbm_tpu_torch.ops import _build

    text = pathlib.Path(path).read_text()
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    out = {}
    for part in SWEEP_SPLIT:
        d = _build.BUILD_ROOT / f"split-{tag}-{part}"
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(split_source(text, part))
        out[part] = _build.load_variant({name: d / name})
    return out


# The entry point of the K9 of PRs 5-13 (csrc/ca_inplace.cu): one K8 launch
# per part, parts of the largest R whose one extended slab fits
# inplace_cuda.L2_INPLACE_BUDGET.
PARTS_SWEEP_ARGTYPES = ("P" * 7) + ("I" * 5) + "FFF" + "IPI"


def parts_sweep_run_all(p, obst, num_steps: int, K: int, lib):
    """A runner of the K9 of PRs 5-13 from a library that has its entry
    ``lbm_hbm_sweep`` (a variant with that version's ``ca_inplace.cu``):
    ``f0 -> (f, tot)`` of whole sweeps (``num_steps`` a multiple of K), one
    K8 launch per part; no plain fallback (card only)."""
    import ctypes

    import torch

    from lbm_tpu_torch.ops import _build, ca_cuda, fused_torch, inplace_cuda

    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    lib.lbm_hbm_sweep.argtypes = [types[c] for c in PARTS_SWEEP_ARGTYPES]
    lib.lbm_hbm_sweep.restype = ctypes.c_int
    R = max(r for r in range(K, p.ny - 2 * K + 1) if p.ny % r == 0
            and inplace_cuda.state_bytes(r + 2 * K, p.nx) <= inplace_cuda.L2_INPLACE_BUDGET)
    ext, dev = R + 2 * K, obst.device
    grid = lib.lbm_ca_inplace_grid(ext, p.nx, 0, dev.index)
    fa = torch.empty((9, p.ny, p.nx), dtype=torch.float32, device=dev)
    fb = torch.empty_like(fa)
    scratch = torch.empty((9, ext, p.nx), dtype=torch.float32, device=dev)
    gate = torch.empty((2, p.nx), dtype=torch.uint8, device=dev)
    partials = inplace_cuda.partials_buffer(ca_cuda.sweep_plan(ext, p.nx, K, grid), K, dev)
    rows = torch.arange(-K, R + K, device=dev)
    obst_parts = obst[torch.remainder(torch.arange(0, p.ny, R, device=dev)[:, None] + rows,
                                      p.ny)].to(torch.uint8).contiguous()
    omega, w1, w2 = fused_torch.step_constants(p)

    def run_all(f):
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        fa.copy_(f)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(num_steps // K):
            src, dst = (fa, fb) if s % 2 == 0 else (fb, fa)
            _build.check(lib.lbm_hbm_sweep(
                src.data_ptr(), dst.data_ptr(), obst_parts.data_ptr(), scratch.data_ptr(),
                gate.data_ptr(), partials.data_ptr(), tot.data_ptr() + 4 * s * K, p.ny, p.nx, R,
                K, p.accel_row, omega, w1, w2, grid, stream, dev.index), "K9 of PRs 5-13")
        return (fb if num_steps // K % 2 else fa), tot

    return run_all


def time_hbm(n: int, device, depths=(4, 8), repeats: int = 5, variants=None,
             parts=(), split: bool = False,
             only=None) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of K1, and of K4, K5 and K9 at each depth,
    in turns, on an n x n closed box from rest.  ``parts`` ((R, S) pairs)
    adds K9 on those part rows and slots (``K9 R=128 S=2 K=4``).  With
    ``variants`` (:func:`load_variants`) the K9 of each that replaces
    ``hbm.cu`` or a header it includes, or ``ca_inplace.cu`` with the
    one-launch-per-part entry of PRs 5-13 (:func:`parts_sweep_run_all`),
    runs in the same turns (``K9@NAME K=4``).  With ``split`` so does the
    :data:`SWEEP_SPLIT` of the package's K9 and of each such variant
    (``K9 floor K=4``, ``K9@NAME step0 K=4``, ...).  ``only`` (names such as
    ``K9@parent``) times those K9s alone, beside K1, K4 and K5."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, fused_cuda, hbm_cuda, skew_cuda, temporal_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    steps = 8 * max(1, 2**27 // (n * n))

    # name -> (lib, runner maker) of every K9 to time
    k9 = {"K9": (None, hbm_cuda.make_run_all)}
    for vname, v in replacing(variants, "hbm.cu").items():
        k9[f"K9@{vname}"] = (v.lib, hbm_cuda.make_run_all)
    for vname, v in replacing(variants, "ca_inplace.cu").items():
        if hasattr(v.lib, "lbm_hbm_sweep") and f"K9@{vname}" not in k9:
            k9[f"K9@{vname}"] = (v.lib, lambda *a, lib: parts_sweep_run_all(*a, lib=lib))
    if only:
        k9 = {key: k9[key] for key in only}
    if split:
        sources = {"K9": ("hbm.cu", _build.CSRC / "hbm.cu")} if "K9" in k9 else {}
        for vname, v in (variants or {}).items():
            for name in ("hbm.cu", "ca_inplace.cu"):
                if name in v.files and f"K9@{vname}" in k9:
                    sources[f"K9@{vname}"] = (name, dict(v.paths)[name])
        for key, (name, path) in sources.items():
            for part, lib in split_libs(name, path).items():
                k9[f"{key} {part}"] = (lib, k9[key][1])

    runs = {"K1": (fused_cuda.make_run_all(p, obst, steps), f0, steps)}
    for K in depths:
        runs[f"K4 K={K}"] = (temporal_cuda.make_run_all(p, obst, steps, K), f0, steps)
        if skew_cuda.supports(p, K):
            runs[f"K5 K={K}"] = (skew_cuda.make_run_all(p, obst, steps, K), f0, steps)
        if not hbm_cuda.supports(p, K):
            continue
        for key, (lib, make) in k9.items():
            name, _, part = key.partition(" ")
            runs[f"{name} {part + ' ' if part else ''}K={K}"] = (
                make(p, obst, steps, K, lib=lib), f0, steps)
        for R, S in parts:
            if hbm_cuda.parts_valid(n, K, R, S):
                runs[f"K9 R={R} S={S} K={K}"] = (
                    hbm_cuda.make_run_all(p, obst, steps, K, rows=R, slots=S), f0, steps)
    return time_in_turns(runs, repeats)


def hbm_tier_ms(n: int, K: int, l2_gbps: float) -> float:
    """K9's L2 tier bound, in ms, for one K-step sweep of an n x n grid on
    ``hbm_cuda.plan``'s parts: the parts' cell-steps, P x (R + 2K) x n x K,
    9 float32 values read and 9 written each, over ``l2_gbps`` (the L2
    copy's rate at the working set of its slots)."""
    from lbm_tpu_torch.ops import hbm_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    R, _ = hbm_cuda.plan(make_scene(f"{n}x{n}").params, K)
    return (n // R) * (R + 2 * K) * n * K * 2 * 9 * 4 / (l2_gbps * 1e9) * 1e3


def format_hbm_bounds(n: int, depths, device, repeats: int = 5) -> str:
    """K9's bounds on an n x n closed box at each depth: the launch's bound
    (:func:`bound_ms`) and its L2 tier bound (:func:`hbm_tier_ms` at the L2
    copy's rate, with a barrier a pass, measured here at the slots' working
    set)."""
    from lbm_tpu_torch.ops import hbm_cuda, inplace_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    p = make_scene(f"{n}x{n}").params
    out = []
    for K in depths:
        if not hbm_cuda.supports(p, K):
            continue
        R, S = hbm_cuda.plan(p, K)
        slots = S * inplace_cuda.state_bytes(R + 2 * K, n)
        rate = l2_copy_gbps(device, slots, True, repeats=repeats)[0]
        b, by = bound_ms(n * n, (n - 2) ** 2, K)
        out.append(f"K9 K={K} (R={R}, S={S}): bound {b * 1e3:.2f} us a launch ({by}), L2 tier "
                   f"{hbm_tier_ms(n, K, rate) * 1e3:.1f} us at {rate:.1f} GB/s "
                   f"({slots / 2**20:.1f} MiB)")
    return f"{n}^2 K9 bounds: " + " | ".join(out)


def time_blocked(n: int, device, repeats: int = 7, block_rows=(8,),
                 steps: int = 2048, variants=None,
                 placements: int = 1) -> dict[str, tuple[float, float, float]]:
    """us/step (median, q1, q3) of K10 (256-step launches, each row-block
    height of ``block_rows``: ``K10 B=8``, ...) in turns with the kernel
    the policy would otherwise give the grid: K2 where two copies fit its
    L2 budget (to 768^2), else K3 and K4 at K = 4 (1024^2); then K10's plain
    version (``plain K10``, 8 steps) on an n x n closed box from rest.
    With ``variants`` (:func:`load_variants`) the K10 of each that replaces
    ``blocked.cu`` (``K10@NAME B=8``) at each height runs in the same
    turns, on ``placements`` placements of the runners' buffers
    (:func:`time_placed`)."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import blocked_cuda, inplace_cuda, resident_cuda, temporal_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)

    def make_runs():
        runs = {}
        for b in block_rows:
            runs[f"K10 B={b}"] = (blocked_cuda.make_run_all(p, obst, steps, block_rows=b), f0,
                                  steps)
            for vname, v in replacing(variants, "blocked.cu").items():
                runs[f"K10@{vname} B={b}"] = (
                    blocked_cuda.make_run_all(p, obst, steps, block_rows=b, lib=v.lib), f0, steps)
        if resident_cuda.fits_l2(n, n):
            runs["K2"] = (resident_cuda.make_run_all(p, obst, steps), f0, steps)
        else:
            if inplace_cuda.fits_l2(n, n):
                runs["K3"] = (inplace_cuda.make_run_all(p, obst, steps), f0, steps)
            if temporal_cuda.supports(p, 4):
                runs["K4 K=4"] = (temporal_cuda.make_run_all(p, obst, steps, 4), f0, steps)
        return runs

    out = time_placed(make_runs, repeats, placements)
    plain_steps = 8
    med, q1, q3 = _quartiles(_timed_ms(
        lambda: blocked_cuda.run_plain(f0, obst, p, plain_steps), min(repeats, 3)))
    out["plain K10"] = (med * 1e3 / plain_steps, q1 * 1e3 / plain_steps, q3 * 1e3 / plain_steps)
    return out


def time_policy(device, repeats: int = 7, variants=None,
                placements: int = 1) -> dict[str, dict[str, tuple[float, float, float]]]:
    """The budget questions, each pair timed in turns in one process:
    K2 vs K3 (f32) at 128^2, 256^2, 512^2, 768^2 and K1-i16 vs K3-i16 at
    512^2, 768^2 and 1024^2; each variant that replaces ``inplace.cu``
    (:func:`load_variants`) adds its K3 or K3-i16 (``K3@NAME``) to the
    turns, each that replaces ``resident.cu`` its K2, and each that
    replaces ``step.cu`` its K1-i16; each pair at ``placements`` placements
    of its buffers (:func:`time_placed`)."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, inplace_cuda, quant, resident_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    out = {}
    for n, storage in ((128, "f32"), (256, "f32"), (512, "f32"), (768, "f32"), (512, "i16"),
                       (768, "i16"), (1024, "i16")):
        scene = make_scene(f"{n}x{n}")
        p = scene.params
        obst = torch.from_numpy(scene.obstacles).to(device)
        f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
        steps = 4000 if n <= 512 else 2000
        if storage == "i16":
            f0 = quant.quantize(f0, p.density)

        def make_runs(p=p, obst=obst, f0=f0, steps=steps, storage=storage):
            sfx = "-i16" if storage == "i16" else ""
            if storage == "f32":
                runs = {"K2": (resident_cuda.make_run_all(p, obst, steps), f0, steps),
                        "K3": (inplace_cuda.make_run_all(p, obst, steps), f0, steps)}
                for vname, v in replacing(variants, "resident.cu").items():
                    runs[f"K2@{vname}"] = (resident_cuda.make_run_all(p, obst, steps,
                                                                      lib=v.lib), f0, steps)
            else:
                runs = {"K1-i16": (fused_cuda.make_run_all(p, obst, steps, "i16"), f0, steps),
                        "K3-i16": (inplace_cuda.make_run_all(p, obst, steps, storage="i16"),
                                   f0, steps)}
                for vname, v in replacing(variants, "step.cu").items():
                    runs[f"K1-i16@{vname}"] = (fused_cuda.make_run_all(p, obst, steps, "i16",
                                                                       lib=v.lib), f0, steps)
            for vname, v in replacing(variants, "inplace.cu").items():
                runs[f"K3{sfx}@{vname}"] = (inplace_cuda.make_run_all(
                    p, obst, steps, storage=storage, lib=v.lib), f0, steps)
            return runs

        out[f"{n}^2 {storage}"] = time_placed(make_runs, repeats, placements)
    return out


def single_runner(p, obst, steps: int):
    """The default single-device program's runner for ``p``
    (``program.cuda_choice``): K2, K3, K4, K5, K9 or K1 (f32)."""
    from lbm_tpu_torch.models import program
    from lbm_tpu_torch.ops import (
        fused_cuda,
        hbm_cuda,
        inplace_cuda,
        resident_cuda,
        skew_cuda,
        temporal_cuda,
    )

    variant, K = program.cuda_choice(p)
    if variant == "cuda-resident":
        return resident_cuda.make_run_all(p, obst, steps), "K2"
    if variant == "cuda-inplace":
        return inplace_cuda.make_run_all(p, obst, steps), "K3"
    sweeps = {"cuda-trapezoid": (temporal_cuda, "K4"), "cuda-skew": (skew_cuda, "K5"),
              "cuda-hbm": (hbm_cuda, "K9")}
    if variant in sweeps:
        mod, name = sweeps[variant]
        return mod.make_run_all(p, obst, steps, K), name
    return fused_cuda.make_run_all(p, obst, steps), "K1"


def time_ensemble(n: int, B: int, device, repeats: int = 7, singles: bool = True,
                  kernels=None, steps: int | None = None
                  ) -> dict[str, tuple[float, float, float]]:
    """us per instance-step (median, q1, q3) of K1-batch, K2-batch (where
    B groups of blocks can be resident), K11 (where one instance fits a
    cluster) and, with ``singles``, B single runs
    of the default single-device kernel (``B x K2`` and so on), in turns, on
    B instances of the n x n closed box with omegas 1.3 to 1.9, from rest,
    ``steps`` a run (default 4000 to 256^2, else 1000); ``kernels`` limits
    the ensemble kernels timed; then of the plain batched step (``plain``,
    10 steps)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, ensemble_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    obst = torch.from_numpy(scene.obstacles).to(device)
    omegas = np.linspace(1.3, 1.9, B, dtype=np.float32)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    f0_b = f0.unsqueeze(0).expand(B, -1, -1, -1).contiguous()
    steps = steps or (4000 if n <= 256 else 1000)
    runs = {}
    lib = _build.load()
    resident = lib.lbm_resident_batch_blocks(device.index)
    clusters = ensemble_cuda.card_clusters(lib, device.index)
    for kernel in kernels or ensemble_cuda.KERNELS:
        if kernel == "K2-batch" and ensemble_cuda.group_blocks(n, n, B, resident) < 1:
            continue
        if kernel == "K11" and ensemble_cuda.cluster_plan(n, n, B, clusters) is None:
            continue
        runs[kernel] = (ensemble_cuda.make_run_all(p, obst, omegas, None, steps, kernel),
                        f0_b, steps * B)
    if singles:
        one = [single_runner(p.replace(omega=float(o)), obst, steps) for o in omegas]

        def run_singles(f):
            for run, _ in one:
                run(f)

        runs[f"{B} x {one[0][1]}"] = (run_singles, f0, steps * B)
    out = time_in_turns(runs, repeats)
    del runs
    plain_steps = 10
    med, q1, q3 = _quartiles(_timed_ms(lambda: ensemble_cuda.run_plain(
        f0_b, obst, p, omegas, None, plain_steps), max(1, min(repeats, 3))))
    scale = 1e3 / (plain_steps * B)
    out["plain"] = (med * scale, q1 * scale, q3 * scale)
    return out


CLUSTER_PARTS = {"whole": 0, "floor": 1, "barrier": 2}


def cluster_part_lib(part: int):
    """The kernel library with K11 built as the split's form ``part``
    (csrc/cluster.cu's LBM_CLUSTER_PART defined ahead of it; 0: the
    package's own library), the variant written under the ignored build
    directory."""
    from lbm_tpu_torch.ops import _build

    if part == 0:
        return _build.load()
    d = _build.BUILD_ROOT / f"cluster-part-{part}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "cluster.cu").write_text(f"#define LBM_CLUSTER_PART {part}\n"
                                  + (_build.CSRC / "cluster.cu").read_text())
    return _build.load_variant({"cluster.cu": d / "cluster.cu"})


def time_cluster_split(n: int, B: int, device, repeats: int = 7, sizes=None, threads=None
                       ) -> tuple[dict[str, tuple[float, float, float]], "ClusterPlan"]:
    """us per launch (median, q1, q3) of K11's split on B instances of the
    n x n closed box, one 256-step chunk a launch, in turns: ``whole``;
    ``floor``, the band and mask loads and the store alone (no step);
    ``barrier``, the floor with every step's barriers, carries and sums
    but no cell (the forms of :func:`cluster_part_lib`).  ``sizes`` pins
    the cluster sizes the plan may take, ``threads`` its block shape (the
    plan's own choice where None).  Returns (times, the plan)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, ensemble_cuda, resident_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    libs = {name: cluster_part_lib(part) for name, part in CLUSTER_PARTS.items()}
    scene = make_scene(f"{n}x{n}")
    p = scene.params
    clusters = ensemble_cuda.card_clusters(libs["whole"], device.index)
    if threads is None:
        plan = ensemble_cuda.cluster_plan(
            n, n, B, lambda C, smem, t: clusters(C, smem, t) if sizes is None or C in sizes else 0)
    else:
        forms = (ensemble_cuda.cluster_form(n, n, B, C, threads, clusters)
                 for C in sizes or ensemble_cuda.CLUSTER_SIZES)
        plan = min((form for form in forms if form), key=lambda form: form.us, default=None)
    if plan is None:
        raise ValueError(f"K11 cannot map {B} x {n}x{n} at cluster sizes {sizes}")
    obst = torch.from_numpy(scene.obstacles).to(device)
    om, w1, w2 = ensemble_cuda.scalars(p, np.linspace(1.3, 1.9, B, dtype=np.float32))
    sc = torch.from_numpy(np.stack([om, w1, w2], axis=1).copy()).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    fa = f0.unsqueeze(0).expand(B, -1, -1, -1).contiguous()
    chunk = resident_cuda.DEFAULT_CHUNK
    tot = torch.empty((chunk, B), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(lib):
        def run(_=None):
            _build.check(lib.lbm_cluster_batch_chunk(
                fa.data_ptr(), fa.data_ptr(), obst.data_ptr(), 0, sc.data_ptr(),
                tot.data_ptr(), n, n, p.accel_row, chunk, plan.C, B, plan.smem, plan.threads,
                stream, device.index), "K11 split")
        return run

    runs = {name: (launcher(lib), None, 1) for name, lib in libs.items()}
    return time_in_turns(runs, repeats), plan


def time_cluster_forms(n: int, B: int, device, repeats: int = 5, steps: int = 1024
                       ) -> tuple[dict[str, tuple[float, float, float]], dict]:
    """us per instance-step (median, q1, q3) on B instances of the n x n
    closed box (omegas 1.3 to 1.9, from rest, ``steps`` a run in 256-step
    chunks), in turns: K11 pinned to every block shape and cluster size
    whose band fits a block and that the card holds (``K11 512x8``: blocks
    of 512 threads, C = 8; ``ensemble_cuda.cluster_form``), whichever the
    plan would take, and K2-batch where its groups can be resident.
    Returns (times, {name: the pinned plan})."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, ensemble_cuda, resident_cuda
    from lbm_tpu_torch.tools.bench import make_scene

    scene = make_scene(f"{n}x{n}")
    p = scene.params
    lib = _build.load()
    clusters = ensemble_cuda.card_clusters(lib, device.index)
    obst = torch.from_numpy(scene.obstacles).to(device)
    omegas = np.linspace(1.3, 1.9, B, dtype=np.float32)
    om, w1, w2 = ensemble_cuda.scalars(p, omegas)
    sc = torch.from_numpy(np.stack([om, w1, w2], axis=1).copy()).to(device)
    f0 = lattice.equilibrium_rest_device(p.density, n, n, device)
    fa = f0.unsqueeze(0).expand(B, -1, -1, -1).contiguous()
    tot = torch.empty((steps, B), dtype=torch.float32, device=device)
    chunk = resident_cuda.DEFAULT_CHUNK
    stream = torch.cuda.current_stream(device).cuda_stream
    plans, runs = {}, {}

    def pinned(plan):
        def run(_=None):
            for done in range(0, steps, chunk):
                _build.check(lib.lbm_cluster_batch_chunk(
                    fa.data_ptr(), fa.data_ptr(), obst.data_ptr(), 0, sc.data_ptr(),
                    tot.data_ptr() + 4 * done * B, n, n, p.accel_row, min(chunk, steps - done),
                    plan.C, B, plan.smem, plan.threads, stream, device.index), "K11 pinned")
        return run

    for threads in ensemble_cuda.CLUSTER_THREADS:
        for C in ensemble_cuda.CLUSTER_SIZES:
            plan = ensemble_cuda.cluster_form(n, n, B, C, threads, clusters)
            if plan is not None:
                name = f"K11 {threads}x{C}"
                plans[name] = plan
                runs[name] = (pinned(plan), None, steps * B)
    if ensemble_cuda.group_blocks(n, n, B, lib.lbm_resident_batch_blocks(device.index)) >= 1:
        runs["K2-batch"] = (ensemble_cuda.make_run_all(p, obst, omegas, None, steps, "K2-batch"),
                            fa.clone(), steps * B)
    return time_in_turns(runs, repeats), plans


def format_forms(n: int, B: int, times: dict[str, tuple[float, float, float]], plans: dict,
                 pick) -> str:
    """One line of :func:`time_cluster_forms`: each pinned form's resident
    clusters, waves and modelled step beside its time; ``pick`` the plan's
    (``cluster_plan`` on the card's counts)."""
    parts = []
    for name, (med, q1, q3) in times.items():
        plan = plans.get(name)
        about = (f" ({plan.resident} resident, {plan.waves} waves, model {plan.us:.3f} us)"
                 if plan else "")
        parts.append(f"{name}{about} {med:.4f} [{q1:.4f}, {q3:.4f}]")
    chosen = f"K11 {pick.threads}x{pick.C}" if pick else "none"
    return (f"K11 forms {n}^2 x {B}, us/instance-step, plan {chosen}: " + " | ".join(parts))


def smem_copy_gbps(device, nbytes: int = 192 * 1024, passes: int = 256, repeats: int = 7
                   ) -> tuple[float, float, float]:
    """(median, q1, q3) GB/s of the shared-memory copy kernel
    (csrc/smem_copy.cu): ``passes`` in-place passes over ``nbytes`` of
    shared memory in every block the card holds at once, a block barrier
    after each, read + write counted: the rate K11's tier bound divides
    by."""
    import torch

    from lbm_tpu_torch.ops import _build

    lib = _build.load()
    n4 = nbytes // 16
    grid = lib.lbm_smem_copy_grid(n4, device.index)
    if grid <= 0:
        raise RuntimeError(f"the shared-memory copy of {nbytes} bytes a block cannot launch")
    out = torch.empty(grid * 256, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        _build.check(lib.lbm_smem_copy(out.data_ptr(), n4, passes, grid, stream,
                                       device.index), "shared-memory copy")

    med, q1, q3 = _quartiles(_timed_ms(run, repeats))
    moved = 2 * 16 * n4 * passes * grid
    return moved / med / 1e6, moved / q3 / 1e6, moved / q1 / 1e6


def format_split(n: int, B: int, times: dict[str, tuple[float, float, float]], plan) -> str:
    return (f"K11 split {B} x {n}^2 ({plan.label()}, {plan.smem} B a block), us a 256-step "
            "launch: " + " | ".join(
                f"{name} {med:.2f} [{q1:.2f}, {q3:.2f}]" for name, (med, q1, q3) in times.items()))


def format_ensemble(n: int, B: int, times: dict[str, tuple[float, float, float]]) -> str:
    return f"{n}^2 x {B} instances: " + " | ".join(
        f"{name} {med:.4f} us/instance-step [{q1:.4f}, {q3:.4f}] {n * n / med:.0f} MLUPS"
        for name, (med, q1, q3) in times.items())


def format_clusters(device, shapes) -> str:
    """The card's resident clusters (``lbm_cluster_batch_max_clusters``) of
    each size at the shared memory K11 takes for each n x n shape of
    ``shapes`` ((n, B) pairs), blocks of 1024 / 512 threads, and the
    shared-memory copy's rate."""
    from lbm_tpu_torch.ops import _build, ensemble_cuda

    lib = _build.load()
    parts = []
    for n in sorted({s[0] for s in shapes}):
        sizes = []
        for C in ensemble_cuda.CLUSTER_SIZES:
            if C > n:
                continue
            smem = ensemble_cuda.cluster_smem(-(-n // C), n)
            got = " / ".join(
                str(lib.lbm_cluster_batch_max_clusters(C, smem, threads, device.index))
                for threads in ensemble_cuda.CLUSTER_THREADS
            ) if smem <= ensemble_cuda.SMEM_MAX else "-"
            sizes.append(f"C={C} {smem} B: {got}")
        parts.append(f"{n}^2: " + ", ".join(sizes))
    med, q1, q3 = smem_copy_gbps(device)
    return ("K11 resident clusters (1024 / 512 threads): " + " ; ".join(parts)
            + f" | shared-memory copy {med:.1f} GB/s [{q1:.1f}, {q3:.1f}]")


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
    parser.add_argument("--hbm", default="", help="grids to time K9 against K4 and K5 on")
    parser.add_argument("--hbm-parts", default="",
                        help="K9 part rows x slots to time beside the plan's, e.g. 128x2,256x1")
    parser.add_argument("--hbm-split", action="store_true",
                        help="time the split of each K9 (no cell; step 0; middle; last)")
    parser.add_argument("--hbm-only", default="",
                        help="time these K9s alone, e.g. K9@parent (default: every one)")
    parser.add_argument("--blocked", default="", help="grids to time K10 against the policy's "
                        "kernel on, e.g. 256,512,768,1024")
    parser.add_argument("--blocked-rows", default="8",
                        help="K10 row-block heights to time, e.g. 4,8,16")
    parser.add_argument("--ensemble", default="",
                        help="GRID:B pairs to time the ensemble's kernels on, e.g. "
                        "128:16,256:8 (n x n grids, B instances)")
    parser.add_argument("--cluster-split", default="",
                        help="GRID:B[:C[:THREADS]] to time K11's split on (whole, loads and "
                        "stores, barriers), e.g. 256:8,128:64:8:512 (C pins the cluster size, "
                        "THREADS the block shape)")
    parser.add_argument("--cluster-forms", default="",
                        help="GRID:B pairs to time K11 on in every block shape and cluster "
                        "size, pinned, in turns with K2-batch, e.g. 128:64")
    parser.add_argument("--clusters", action="store_true",
                        help="print the card's resident clusters of each size at the "
                        "--ensemble shapes' shared memory, and the shared-memory copy rate")
    parser.add_argument("--policy", action="store_true")
    parser.add_argument("--l2", action="store_true",
                        help="time the L2 copy kernel at K8's and K3's working sets")
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH[+PATH...]: time the kernels of other versions of "
                        "step.cu, resident.cu, ghosted.cu, temporal.cu, skew.cu, inplace.cu, "
                        "ca_inplace.cu, hbm.cu, ca_resident.cu or blocked.cu in turns with "
                        "the package's own")
    parser.add_argument("--k4-regions", default="",
                        help="compiled regions of K4 and K4-slab to time beside the table's, "
                        "e.g. 48x64")
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--placements", type=int, default=1,
                        help="--policy, --ca and --blocked: time the kernels on this many "
                        "placements of their buffers, the rounds pooled")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("Error: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    variants = load_variants(args.variant)
    regions = tuple(tuple(int(v) for v in r.split("x")) for r in args.k4_regions.split(",") if r)
    med, q1, q3 = copy_gbps(device, args.repeats)
    print(f"copy 1 GiB: {med:.1f} GB/s [{q1:.1f}, {q3:.1f}] | {card}")
    if args.l2:
        print(format_l2(l2_rates(device, args.repeats)) + f" | {card}")
    for n in (int(g) for g in args.grids.split(",") if g):
        print("in turns " + format_grid(n, time_grid(n, device, args.repeats, variants))
              + f" | {card}")
    depths = tuple(int(k) for k in args.depths.split(","))
    for n in (int(g) for g in args.sweeps.split(",") if g):
        print(format_grid(n, time_sweeps(n, device, depths, args.repeats, variants=variants,
                                                 regions=regions))
              + f" | {card}")
    for n in (int(g) for g in args.shards.split(",") if g):
        print(format_shard(n, time_shard(n, device, repeats=args.repeats, variants=variants))
              + f" | {card}")
    ca_depths = tuple(int(k) for k in args.ca_depths.split(","))
    hbm_parts = tuple(tuple(int(v) for v in rs.split("x")) for rs in args.hbm_parts.split(",")
                      if rs)
    ca_parts = tuple(int(k) for k in args.ca_parts.split(","))
    for shard in (s for s in args.ca.split(",") if s):
        nloc, nx = (int(v) for v in shard.split("x"))
        print(format_ca(nloc, nx, time_ca(nloc, nx, device, ca_depths, ca_parts, args.repeats,
                                          variants=variants, regions=regions,
                                          placements=args.placements)) + f" | {card}")
    for n in (int(g) for g in args.hbm.split(",") if g):
        print(format_grid(n, time_hbm(n, device, ca_depths, args.repeats, variants, hbm_parts,
                                      args.hbm_split,
                                      [k for k in args.hbm_only.split(",") if k]))
              + f" | {card}")
        print(format_hbm_bounds(n, ca_depths, device, args.repeats) + f" | {card}")
    rows = tuple(int(b) for b in args.blocked_rows.split(","))
    for n in (int(g) for g in args.blocked.split(",") if g):
        print("in turns " + format_grid(n, time_blocked(n, device, args.repeats, rows,
                                                        variants=variants,
                                                        placements=args.placements))
              + f" | {card}")
    for pair in (e for e in args.ensemble.split(",") if e):
        n, B = (int(v) for v in pair.split(":"))
        print("in turns " + format_ensemble(n, B, time_ensemble(n, B, device, args.repeats))
              + f" | {card}")
    for triple in (e for e in args.cluster_split.split(",") if e):
        n, B, *C = (int(v) for v in triple.split(":"))
        times, plan = time_cluster_split(n, B, device, args.repeats, tuple(C[:1]) or None,
                                         C[1] if len(C) > 1 else None)
        print("in turns " + format_split(n, B, times, plan) + f" | {card}")
    for pair in (e for e in args.cluster_forms.split(",") if e):
        from lbm_tpu_torch.ops import _build, ensemble_cuda

        n, B = (int(v) for v in pair.split(":"))
        times, plans = time_cluster_forms(n, B, device, args.repeats)
        pick = ensemble_cuda.cluster_plan(
            n, n, B, ensemble_cuda.card_clusters(_build.load(), device.index))
        print("in turns " + format_forms(n, B, times, plans, pick) + f" | {card}", flush=True)
    if args.clusters:
        print(format_clusters(device, [tuple(int(v) for v in e.split(":"))
                                       for e in args.ensemble.split(",") if e])
              + f" | {card}")
    if args.policy:
        for key, times in time_policy(device, args.repeats, variants,
                                      args.placements).items():
            print("in turns " + format_grid(int(key.split("^")[0]), times)
                  + f" ({key.split()[1]}) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
