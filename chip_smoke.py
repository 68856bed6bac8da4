#!/usr/bin/env python3
"""On-card smoke test of lbm_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, anchors the main path to the numpy
oracle and to the 1024x1024 golden run, drives the CLI end to end (run,
--plan, --profile, --divergence, golden), writes the verify artifact, and
times kernels and twin.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; every number sits beside the card's name and
power limit as nvidia-smi reports them):

1. the card, torch and CUDA versions, the kernel build (one nvcc per
   source, all started together) and the C++ writer of final_state.dat
   (``make native``; the Python writer where it cannot be built);
2. K1 (one-step kernel) vs its plain version: 1024x1024, 1536x1536,
   2048x2048 and 60x100 closed boxes with an interior block and the driven
   row, 50 steps, from rest and (all but 1024x1024) from a seeded random
   perturbation of rest with the injection guard false at some driven-row
   cells; fields torch.equal, per-step tot_u within rtol 1e-6;
3. K2 (persistent multi-step kernel) vs its plain version: 128x128, 256x128,
   256x256 with (steps, chunk) in {(7,4), (8,4), (5,8), (600,256)},
   256x256 from the perturbed state for 600 steps, and the band-edge shapes
   :data:`K2_EDGES` from the perturbed state over two chunks and a step at
   chunks 1, 2, 3, 8 and 256; same bounds; the script fails unless the
   blocks' bands (the band plan on the card's grid) put the driven row on a
   band's first row and on its last, and split rows between blocks;
3b. K3 (in-place persistent kernel) vs its plain version: 1024x1024 and
   1021x1023 from rest and from the perturbed state, 200 steps; 60x100,
   7x33 (a wall on the driven row) and 45x99 with (steps, chunk) in
   {(7,4), (8,4), (5,8), (600,256)} (odd counts end in the second buffer);
   same bounds; and K3 vs K1, both kernels, at 1024x1024 over 20000
   steps: fields torch.equal, tot_u within rtol 1e-6; over 3b and 3c the
   script fails unless the blocks' bands (the band plan on the card's
   grid) put the driven row on a band's first row and on its last, and
   split rows between blocks;
3c. the int16 kernels vs their plain version (int16 fields torch.equal,
   tot_u rtol 1e-6): K1-i16 at 1024x1024, 1536x1536 and 2048x2048 x 50
   steps from rest and perturbed starts, and at the shapes its two columns
   a lane and 64 x 8 cells a block make hard (:data:`K1_I16_EDGES`: nx
   33, 64, 65, 130, 1023 and 2, odd nx taking 16-bit accesses, the driven
   row on the first and the last row of a block's 8) and at 16384x14564 x
   2 steps (9 ny nx just above 2^31: its long long offsets), K3-i16 at
   256x256, 1024x1024 (the
   largest grid the policy gives it) and 1536x1536 from rest and
   perturbed starts (200 steps), on the small grids above and at 256x256
   with (steps, chunk) = (600, 256), and K3-i16 vs K1-i16 at 1024x1024
   over 20000 steps;
3d. the sweep kernels K4 (trapezoid) and K5 (skewed) vs their plain
   version, f32 and int16: 1024x1024, 1536x1536, 2048x2048, a ragged
   1000x1500, 1061x1499 (odd nx: rows that take K4's 4-byte copies and
   int16 rows from odd elements; the driven row in the last row of a tile's region at K=4) and
   60x100 (fewer tiles than the persistent grid) at K in {2, 4, 8}, 50
   steps (51 at K=2, so that every run ends in a K1 tail), and 4096x4096
   over 2K steps, from rest and from the perturbed state; fields (int16
   too) torch.equal, tot_u within rtol 1e-6; the script fails unless K4's
   cases reach the driven row in the first and last region row, tile counts
   below and not a multiple of the persistent grid, every float32 copy path
   (tiles that wrap in x, rows in 16-byte and in 4-byte copies) and int16
   region rows that start at an odd element; K5 also, f32 and int16 from
   both starts over two sweeps and a K1 step, at the shapes its walk makes
   hard (:func:`k5_hard_shapes`: bands that its 2 rows a step do not divide
   and bands shorter than 2 (K + 1), nx below one strip, ny = 2K, odd nx
   and nx = 2 mod 4), failing unless its cases put the driven row on the
   first and the last of a walk step's rows at every level and reach every
   width of level-0 copy (16, 8 and 4 bytes, and int16's plain loads);
3e. at 2048x2048 over 8000 steps, K=4: K4 and K5 vs K1 (fields
   torch.equal, tot_u rtol 1e-6), and K4-i16 vs K5-i16 (both quantize
   once per sweep: int16 fields torch.equal);
3f. the sharded modes' kernels vs their plain versions
   (:func:`slab_kernel_checks`): K1-slab and K1-slab-i16 on shards of 2,
   8, 13 and 256 rows, nx 1024 and 100, and on the 1024x4096 shard of
   4096x4096 over 4 (phases 5f and 6d), the driven row in the body, in
   either ghost and in none, the whole slab and overlap's three windows,
   rest and perturbed starts; K1-slab-i16 also on shards of 1 and 9 rows
   with nx 33, 64 and 65, the driven row on the first and the last body
   row too, and on 9-row windows of a tensor whose planes lie 2^28
   elements apart (long long offsets); K6 on 256x1024, 13x100, 8x1024 and
   30x129 at chunks 1, 2, 3, 8 and 256, two chunks a case, the driven row
   also on the body's first and last row and on a row two blocks' bands
   share (the script fails unless that put it on a band's first and last
   row, rows split between blocks); fields torch.equal (int16 too), tot_u
   within rtol 1e-6;
3g. the ca engines vs the plain ca sweep (:func:`ca_kernel_checks`):
   K4-slab, K4-slab-i16 (once-per-sweep codec), K7 (where two copies of
   the extended slab fit its L2 budget), K8 and K8-i16 (per-step codec) on
   the 256x1024 and 1024x4096 shards of the 1024^2 and 4096^2 runs over 4,
   8-, 13- and 24-row shards and nx = 100 and 99, at K in {2, 3, 4, 8}, the
   driven row in the body, either ghost region and none (K4-slab also in
   the first and last row of its first tile's region), rest and perturbed
   starts;
   fields torch.equal (int16 too), tot_u within rtol 1e-6; the script fails
   unless K8's cases put the driven row on the first and the last row of a
   block's cells in some step, and rows split between blocks, and unless
   K7's cases (its own 32-cell-aligned plan) put it on the first and the
   last row of a block's cells in some step;
3h. K9 (the HBM-parts sweep, one launch per sweep) vs its plain version
   and vs K1 at 2048x2048 and 60x100, K in {2, 3, 4, 8}, and on 2, 3 and 8
   parts in 2 and 3 slots with the driven row in either ghost region and
   across the wrap, a second run bitwise equal (:func:`hbm_kernel_checks`);
3i. K10 (the two-copy row-block kernel) vs its plain version at 128^2,
   256^2, 512^2, 1024^2 and 72x100, the driven row in the first, a middle
   and the last row block and on a block edge (512^2 and 1024^2: the last
   only), odd and even chunks, rest and perturbed starts, and 256 steps in
   one chunk at 128^2, fields and tot_u torch.equal (its tiles' rows split
   over 8 warps to 512^2 and over 2 at 1024^2); and vs K2 at 512^2 over
   256 steps (:func:`blocked_kernel_checks`);
4. the cuda main path on a 128x128 scene for 120 steps vs core/oracle:
   fields atol 2e-7, av rtol 1e-4;
5. ``lbm_tpu_torch run`` on 256x256 (4400 steps: K2, two segments) and
   1024x1024 (2000 steps) as --variant cuda and --variant torch;
   ``check`` of cuda against torch must pass; 256x256 also with
   --storage i16 (K3-i16), passing ``check`` against the f32 run; the K2,
   K3 and K3-i16 launch counters, zeroed just before the cuda runs, must
   have gone up;
5b. the golden run: the 1024x1024 reference scene rebuilt from golden/
   (obstacles from column 7 of the final state), ``run --variant cuda``
   for the full 20000 steps with --storage f32 (variant cuda-inplace),
   --storage i16 (the default, cuda-inplace-i16: one quantization per step)
   and --storage i16 --temporal-k 4 (cuda-trapezoid-i16: one per 4 steps),
   each passing ``check`` against golden/ (1%); the K3, K3-i16 and K4-i16
   counters must have gone up in these runs;
5l. K10's main path: ``LBM_RESIDENT_KIND=blocked run`` on 5b's golden scene,
   20000 steps (cuda-blocked), final_state.dat byte-identical to 5b's
   cuda-inplace run, av_vels within rtol 1e-6 of it (the same fields, |u|
   summed in another order) and passing ``check`` against golden/; K10's count,
   zeroed just before, must have gone up; the forced ``mono`` and
   ``inplace`` kinds on phase 5's 256x256 scene byte-identical to its
   default run, and ``mono`` at 1024x1024 (it cannot map) exiting 1;
5c. 1536x1536 and 2048x2048 channel scenes (2000 steps) run as
   ``--variant cuda --temporal-k 1`` in f32 (K1), as ``--variant cuda
   --storage i16`` (the default policy: K1-i16) and as ``--variant
   torch``: the f32 cuda run passes ``check`` against torch with a
   byte-identical final_state.dat, and the i16 run passes ``check`` (1%)
   against the f32 cuda run; the K1 and K1-i16 counters, zeroed just
   before, must have gone up;
5d. the temporal path through the CLI, ``--variant cuda`` in f32 and
   int16, under the default policy and with ``--temporal-k 4`` under
   LBM_TEMPORAL_IMPL=trapezoid and =skew: 1536x1536 f32 (default policy
   only) and 2048x2048 channel x 2000 steps, 4096x4096 x 400 (there the
   f32 default is the forced skew's variant and depth, so that run is not
   repeated, and the forced runs go through ``run_simulation``, their
   fields held in memory: each final_state.dat there is 1.5 GB of text);
   each run reports the variant the policy table gives (f32: K5, cuda-skew,
   since it beat K4 in turns at K=4 from 1024^2 cells); the 1536x1536 and
   2048x2048 f32 runs, default (K5) and forced, write a final_state.dat
   byte-identical to 5c's --variant torch run (2048x2048 also passing
   ``check``), the 4096x4096 forced f32 trapezoid run's fields equal the
   default (K5) run's; the default int16
   runs (K1-i16) pass ``check`` against their grid's default f32 run (1%),
   the forced int16 sweeps at 2048x2048 within I16_SWEEP_TOLERANCE (2.5%,
   the envelope measured for int16 quantized once per sweep there), and
   the forced K4-i16 and K5-i16 runs (both K=4) are byte-identical (4096^2:
   equal fields), so only K4-i16's is ``check``ed;
   ``bench --grid 2048x2048`` runs the default policy's variant; the K4,
   K4-i16, K5 and K5-i16 counters, zeroed just before, must have gone up;
5e. the sharded CLI on the 1024x1024 golden scene over 4 shards of the
   card (``--host-devices 4``), 20000 steps: sync's final_state.dat
   byte-identical to 5b's single-device f32 run (cuda-inplace, whose
   fields equal K1's) with av_vels within 1e-6 relative, overlap's
   byte-identical to sync's, async passing ``check`` against golden/ (1%),
   sync --storage i16 byte-identical to 5b's int16 run (cuda-inplace-i16);
   2000 steps of async-k (k = 2) and 2001 of chunked (k = 2: K6 and a
   one-step sync tail) each passing ``check`` (1%) against an f32 sync run
   of the same length; the K1-slab, K1-slab-i16 and K6 counters, zeroed
   just before, must have gone up, each in the runs that use it;
5h. ca on the golden scene over 4 shards of the card, 20000 steps, at
   the default depth: on auto (K7, K = 8) and with LBM_CA_ENGINE=slab
   (K4-slab, K = 4), =resident with --staleness 4 (K7, K = 4) and
   =inplace (K8, K = 8), each
   final_state.dat byte-identical to 5b's single-device f32 run and passing
   ``check`` against golden/; ca-i16 on the default int16 engine (K8-i16,
   quantized every step: byte-identical to 5b's cuda-inplace-i16) and with
   LBM_CA_ENGINE=slab (K4-slab-i16, once per 4 steps: byte-identical to
   cuda-trapezoid-i16), each passing ``check`` (1%); ``--variant auto
   --host-devices 4`` x 2001 steps reads ``ca-8+sync-tail1`` and writes
   sync's final_state.dat (5e); the counts of the ca engines, zeroed just
   before, must have gone up, each in the runs that use it;
5n. the multi-process form on the one card: ``run`` of the golden scene on
   2 processes (tools/pod.py ``launch``; they share the card, so gloo,
   the ghost rows through pinned host buffers) x 2 shards each: sync and
   ca on auto (K7, K = 8) x 20000 steps, each final_state.dat
   byte-identical to 5b's single-device f32 run and av_vels within rtol
   1e-6; async-2 x 2000 passing ``check`` (1%) against 5e's sync run of that
   length; rank 0 alone reports; every rank prints its K1-slab and K7
   counts, which must show its launches; tools/dryrun.py on 2 processes x
   4 shards (21 relations, ulp 0); ``LBM_DIST_BACKEND=nccl`` on the shared
   card exits 1 with ``Error:``; each run's MLUPS and time per step on the
   host's clock.  A rank that fails or outlives 300 s fails the script;
5m. frames, debug and checkpoint/resume on the card: the golden scene
   through ``run_simulation`` with frames every 100 steps (200 frames of
   1024x1024 on the card) on cuda-inplace (K3) and cuda-blocked (K10), f
   and av_vels equal to the plain runs (cuda-blocked: 5l's), the frames
   equal to each other and frames 0, 1, 100 and 199 to the twin's u_mag of
   a K1 run stopped at those steps; the same over 4 shards x 2000 steps in
   sync and ca-8 (frames equal to the single-device ones, fields to the
   plain runs, ca's to sync's); ``--debug`` on ca over 4 shards x 2000
   steps reads ``ca-8+debug-as-sync`` and equals sync;
   the CLI on phase 5's 256x256 scene with ``--frame-interval 400`` (11
   frame files, outputs byte-identical to the plain run) and ``--debug`` x
   400 on cuda-resident (byte-identical); ``--checkpoint-every 4000`` on the
   golden scene's first 8000 steps (its av_vels.dat the unbroken run's
   first 8000 lines), then ``--resume`` from step 8000, byte-identical to
   the unbroken run;
5k. ``LBM_TEMPORAL_IMPL=hbm`` through ``run`` on 5c's 2048x2048 channel
   (2000 steps, K = 4, K9): final_state.dat byte-identical to 5c's
   ``--temporal-k 1`` (K1) run; K9's count, zeroed just before, must be
   one launch a sweep (the run's 500 and the warm-up's one);
5f. large shards: a 4096x4096 channel over 4 shards of 1024x4096, 200
   steps, sync's fields equal to the single-device K1 run's
   (``--temporal-k 1``), av within rtol 1e-6; chunked (k = 2) on the
   K1-slab loop (K6's counter unchanged), within 1% of sync's av;
5g. the dryrun analog (tools/dryrun.py) on 8 shards of the card: every
   relation holds with ulp 0;
a. the verify artifact (tools/verify_device.py ``run_verify``): one probe
   per kernel form of the kernel table, 19, each its wrapper against the
   twin on one recipe, every max |diff| 0, and the golden prefixes (f32
   and int16, 120 steps of the golden scene) under 1%; written into the
   temporary directory and printed as its JSON line;
b. ``run --plan`` for every run of 5b, 5e, 5h, 5k and 5l, under the run's
   forcing variables: its ``program`` is the run's Variant line and its
   ``kernel`` the one the run's launch counters showed;
c. ``run --profile`` on the golden scene x 2000 steps (K3) and sync over 4
   shards x 200: output files byte-identical to an unprofiled run's, the
   trace holds the launched kernel's events (``lbm_inplace_kernel``,
   ``lbm_slab_kernel``); each run's device busy share (kernel time over
   the compute bracket) and host time per step beyond the kernels;
d. ``run --divergence`` on the golden scene over 4 shards, async-1 x 2000
   steps: the av_sync column equals 5e's sync run's av_vels.dat (as
   float32), the last field_rel_linf printed;
e. ``golden --variant cuda`` on phase 5's 256x256 scene: both files
   byte-identical to that run's;
6. MLUPS of those runs, and K1 / K2 / K3 / K1-i16 / K3-i16 (in turns) /
   twin times at 128^2 .. 1024^2 and K1 / K1-i16 / K3-i16 / twin at 1536^2
   (tools/kernel_times.py) beside a 1 GiB device copy's bandwidth, the L2
   copy's (csrc/l2_copy.cu: one buffer of 9.6, 18 and 36 MiB read and
   written in place, with and without a grid barrier per pass); K4 / K5 / K4-i16 /
   K5-i16 at K in {2, 4, 8} at 1536^2, 2048^2 and 4096^2, in turns with
   K1 / K1-i16, beside the plain sweep's time; (6d) MLUPS of every
   sharded discipline at 1024^2/4 (5e) and 4096^2/4 (400 steps, beside
   the single-device default; sync-i16 too, its fields equal to
   cuda-step-i16's), and K1-slab / K1-slab-i16 / K6 us/step on
   the 256x1024 and 1024x4096 shards beside their plain versions and bounds
   (each host-paced, as the sharded runs call it, and card-paced, the
   same loop replayed from a CUDA graph),
   and ca-4 at 4096^2/4 (K4-slab) with fields equal to sync's; (6e) the ca
   engines in turns on the 256x1024 (K = 4, 8) and 1024x4096 (K = 4; K8
   split) shards, and K9 against K5, K4 and K1 in turns at 2048^2; (6f) K10 in turns
   with K3 and K4 (K = 4) at 1024^2;
7. one JSON line of kernel findings (one row per kernel, with the
   launches of the main path's run, its time per launch beside its plain
   version's and its bound, the least time of the launch's bytes over
   3.35 TB/s or its operations over 67 TFLOP/s, and its tier bound: for a
   state in device memory its bytes over the 1 GiB copy's measured rate,
   for a state in L2 its cell-steps' bytes over the L2 copy's; K4,
   K5 and their int16 forms timed at 2048x2048, K=4, and at each grid and
   depth of 6c under "by_grid_and_depth"; K1-slab, K1-slab-i16 and K6 at
   their card-paced time, the host-paced one beside it), then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no final line.  It
does the same when no CUDA device is present, and when the package is not
beside it.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

GRID_SIZES = (128, 256, 512, 1024)
# Phase 5n: each rank runs the CLI's ``run``, then prints its launch counts
# (a fresh process: they start from 0).
POD_CHILD = """
import json, sys
from lbm_tpu_torch import cli
from lbm_tpu_torch.ops import ca_cuda, fused_cuda
rc = cli.main(sys.argv[1:])
print("LAUNCHES " + json.dumps({"K1-slab": fused_cuda.SLAB_LAUNCHES,
                                "K7": ca_cuda.RESIDENT_LAUNCHES}), flush=True)
sys.exit(rc)
"""
POD_TIMEOUT = 300  # seconds a 2-process launch of 5n may take
SWEEP_GRIDS = (1536, 2048, 4096)
SWEEP_DEPTHS = (2, 4, 8)
# The forced int16 sweeps (--temporal-k 4: one quantization per 4 steps, as
# lbm_tpu) against f32, in percent: measured 1.5-2.1% max av_vels deviation
# on the 1536^2-2048^2 channel x 2000 steps at K = 2-4, where the default
# int16 (K1-i16, one quantization per step) stays under 1% (0.43-0.55%) but
# reaches 2.3% by 8000 steps (PERF.md, Findings).  That is why the
# default policy does not sweep int16; every default-policy run, int16
# included, is held to the checker's 1%.
I16_SWEEP_TOLERANCE = 2.5
# The variant the default policy runs for each CLI scene of phase 5d (the
# H100 table, PERF.md section 5: f32 on K5 at K=4 from 1024^2 cells, where
# it beat K4 in turns, int16 on K1-i16).
DEFAULT_VARIANTS = {("1536x1536", "f32"): "cuda-skew",
                    ("2048x2048", "f32"): "cuda-skew",
                    ("2048x2048", "i16"): "cuda-step-i16",
                    ("4096x4096", "f32"): "cuda-skew",
                    ("4096x4096", "i16"): "cuda-step-i16"}


def last_row_ny(temporal_cuda) -> int:
    """A grid whose driven row (ny - 2) is the last row of a tile's region
    at K = 4: tile row y0 = ny - th - 5 (a multiple of th) holds region rows
    y0 - 4 .. y0 + th + 3 = ny - 2.  (At K = 2 every grid's driven row is
    region row 0 of tile row 0.)"""
    th = temporal_cuda.tile(4)[0]
    return th * (1024 // th + 1) + 4 + 1


def k5_hard_shapes(K: int) -> list[tuple[int, int, int]]:
    """(ny, nx, band rows) that K5's walk makes hard, as
    tests/test_torch_skew.py runs them: bands that R = 2 does not divide
    and bands shorter than R (K + 1), nx below one strip, ny = 2K (bands
    wrapping the grid), odd nx (float32 4-byte copies, int16 plain loads)
    and nx = 2 mod 4 (8- and 4-byte copies)."""
    return [(17, 40, 3), (60, 100, 5), (30, 20, 7), (2 * K, 33, 2 * K), (31, 66, 4),
            (45, 99, 6)]


def k4_cover(paths: dict, temporal_cuda, ny: int, nx: int, K: int, accel_row: int) -> None:
    """Add to ``paths`` what a K4 launch on an ny x nx grid at depth K
    reaches: the region rows holding the driven row ("driven"), whether its
    tiles are fewer than the persistent grid or not a multiple of it
    ("tiles"), and the copy paths of its float32 region rows ("copies",
    with "int16 odd element" where an int16 region row starts at an odd
    element)."""
    th, tw = temporal_cuda.tile(K)
    rh = th + 2 * K
    order = temporal_cuda.tile_order(ny, nx, K)
    ntiles = len(order)
    grid = temporal_cuda.persistent_grid(K, 1 << 30)  # the blocks the card holds at once
    paths["tiles"].add("fewer" if ntiles < grid else ("ragged" if ntiles % grid else "whole"))
    for (_, y0, x0), in order:
        for r in range(rh):
            if (y0 - K + r) % ny == accel_row:
                paths["driven"].add(r)
        for row in (0, 1):
            paths["copies"].add(temporal_cuda.copy_path("f32", nx, K, x0, tw, 4 * row * nx))
            if (row * nx + x0 - K) % 2:
                paths["copies"].add("int16 odd element")


def band_cover(paths: set, plan, nx: int, drow: int) -> None:
    """Add to ``paths`` what a K3 or K8 launch with the band plan ``plan``
    (ops/inplace_cuda.py band_plan) reaches: "first" / "last" where the
    driven row (row ``drow`` of the plan's grid) is the first / last row of
    a block's cells in some step, and "split rows" where a block's cells
    start inside a row (the rows do not divide among the blocks)."""
    for step in plan:
        for s, e, _, _ in step:
            if s % nx:
                paths.add("split rows")
            if s // nx == drow:
                paths.add("first")
            if (e - 1) // nx == drow:
                paths.add("last")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def box_scene(ny: int, nx: int, accel: float = 0.005):
    """Closed box (walls on all four sides) with an interior block; the
    driven row ny-2 runs through it."""
    import numpy as np

    from lbm_tpu_torch.params import LBMParams

    p = LBMParams(nx=nx, ny=ny, max_iters=100, reynolds_dim=10,
                  density=0.1, accel=accel, omega=1.85)
    m = np.zeros((ny, nx), dtype=bool)
    m[0, :] = m[-1, :] = True
    m[:, 0] = m[:, -1] = True
    m[ny // 3: ny // 3 + max(2, ny // 16), nx // 4: nx // 4 + max(2, nx // 16)] = True
    # a wall cell on the driven row itself, so the injection guard sees one
    m[ny - 2, nx // 2] = True
    return p, m


def mixed_state(p, dev):
    """The rest state with a seeded random 10% perturbation, and the driven
    row's injection guard false at every third cell: the rows next to the
    driven row, which pull injected values, are where a wrong guard shows."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice

    rng = np.random.default_rng(5)
    noise = rng.uniform(-0.1, 0.1, size=(9, p.ny, p.nx)).astype(np.float32)
    f = lattice.equilibrium_rest(p.density, p.ny, p.nx) * (np.float32(1.0) + noise)
    w1, _ = lattice.accel_weights(p.density, p.accel)
    f[3, p.accel_row, ::3] = w1 * np.float32(0.5)
    return torch.from_numpy(f).to(dev)


def compare(name: str, f_k, tot_k, f_p, tot_p) -> tuple[float, float]:
    """Fields must be bitwise equal, per-step tot_u within rtol 1e-6."""
    import torch

    if not (bool(torch.isfinite(f_k).all()) and bool(torch.isfinite(f_p).all())):
        fail(f"{name}: non-finite state")
    err = float((f_k.double() - f_p.double()).abs().max())
    if not torch.equal(f_k, f_p):
        fail(f"{name}: fields differ from the plain version (max |diff| {err:.3e})")
    rel = float(((tot_k - tot_p).abs() / tot_p.abs().clamp_min(1e-30)).max()) if len(tot_p) else 0.0
    if not torch.allclose(tot_k, tot_p, rtol=1e-6, atol=0.0):
        fail(f"{name}: per-step tot_u off the plain version by {rel:.3e} relative")
    return err, rel


# Phase 3's band-edge shapes of K2 (one block per 256 cells): bands end
# mid-row, the driven row (ny - 2) the last row of one band and the first
# of the next (30x129: rows split two ways; 7x1000: four ways), and bands
# spanning rows (45x33).
K2_EDGES = ((30, 129), (7, 1000), (45, 33))


# Phase 3c's edge shapes of K1-i16 (64 columns and 8 rows a block, two
# columns a lane): nx below, at, just above and well above a warp's
# columns, odd (16-bit accesses) and tiny, and the driven row (ny - 2) on
# the first (ny = 10, 1026) and the last (ny = 17, 1025) row of a block's 8.
K1_I16_EDGES = ((10, 33), (17, 33), (10, 64), (17, 64), (10, 65), (17, 65), (17, 130),
                (1026, 1023), (1025, 1023), (10, 2))


def slab_kernel_checks(dev, k6_paths: set) -> tuple[dict[str, float], dict[str, int]]:
    """Phase 3f: K1-slab and K1-slab-i16 against the plain slab step, and K6
    against its plain version (chunk frozen-ghost slab steps), every case
    bitwise on fields (int16 too) and tot_u within rtol 1e-6.

    K1-slab: shards of 2, 8, 13 and 256 rows, nx 1024 and 100 (not a
    multiple of 32) of a 1024-row grid, and the 1024x4096 shard of
    4096x4096 over 4 shards (the large-shard runs of phases 5f and 6d), the
    driven row in the body, in the ghost below, in the
    ghost above and in none (K1-slab-i16 also on shards of 1 and 9 rows
    with nx 33, 64 and 65, the driven row on the first and the last body
    row too: its warps take whole rows of 64 columns; and on 9-row windows,
    nx 64 and 65, of one tensor whose planes lie 2^28 elements or more
    apart, which take its long long offsets), the whole slab
    (separate ghost tensors) and
    overlap's three windows of one shard tensor (interior, bottom, top:
    the shard's own edge rows as ghosts, written into windows of the new
    state), from rest and from a seeded perturbation with the injection
    guard false at every third cell.  K6: shards of 256x1024 (the 1024^2
    golden grid over 4 shards), 13x100, 8x1024 and 30x129 x chunks 1, 2, 3,
    8 (and 256 from the perturbed start), two chunks a case (the second
    through the launcher the first one's result asks for), the driven row
    in the body's middle, first or last row, on a row two blocks' bands
    share, in each ghost and none, rest and perturbed; ``k6_paths`` gains
    where K6's cases put the driven row in the blocks' bands
    (:func:`band_cover`).  Returns the largest |diff| per kernel and the
    number of cases."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, fused_cuda, ghosted_cuda, quant
    from lbm_tpu_torch.params import LBMParams

    err = {"K1-slab": 0.0, "K1-slab-i16": 0.0, "K6": 0.0}
    cases = dict.fromkeys(err, 0)

    def field(n, nx, start):
        """(params, slab, obst slab) of an n-row shard of a grid of 4n rows
        (at least 1024) cut from a seeded field: rows 1..n of n + 2 are the
        body, walls on the slab's edge columns and on every seventh cell of
        a middle column."""
        p = LBMParams(nx=nx, ny=max(1024, 4 * n), max_iters=1, reynolds_dim=10, density=0.1,
                      accel=0.01, omega=1.85)
        f = lattice.equilibrium_rest(p.density, n + 2, nx)
        if start == "mixed":
            rng = np.random.default_rng(7 + n + nx)
            f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
            w1, _ = lattice.accel_weights(p.density, p.accel)
            f[3, :, ::3] = w1 * np.float32(0.5)
        m = np.zeros((n + 2, nx), dtype=bool)
        m[:, 0] = m[:, -1] = True
        m[::7, nx // 2] = True
        ft = torch.from_numpy(f).to(dev)
        return p, ft, torch.from_numpy(m).to(dev)

    def offset(n, where, p):
        """The row offset that puts the driven row in the body (its middle,
        first or last row), a ghost or none."""
        return {"body": p.accel_row - n // 2, "lo": p.accel_row + 1, "hi": p.accel_row - n,
                "none": 0, "first": p.accel_row, "last": p.accel_row - n + 1}[where]

    def held(name, out, tot, ref, ref_tot):
        e = float((out.double() - ref.double()).abs().max())
        if not torch.equal(out, ref):
            fail(f"{name}: fields differ from the plain version (max |diff| {e:.3e})")
        if not torch.allclose(tot, ref_tot, rtol=1e-6, atol=0.0):
            fail(f"{name}: tot_u {tot.tolist()} vs plain {ref_tot.tolist()}")
        return e

    wheres = ("body", "lo", "hi", "none")
    shapes = [(n, nx) for n in (2, 8, 13, 256) for nx in (1024, 100)] + [(1024, 4096)]
    i16_edges = [(n, nx) for n in (1, 9) for nx in (33, 64, 65)]
    for storage in ("f32", "i16"):
        kern = "K1-slab" + ("-i16" if storage == "i16" else "")
        for n, nx in shapes + (i16_edges if storage == "i16" else []):
            for start in ("rest", "mixed"):
                p, f, m = field(n, nx, start)
                if storage == "i16":
                    f = quant.quantize(f, p.density)
                shard, ghost_lo, ghost_hi = f[:, 1:-1], f[:, :1].clone(), f[:, -1:].clone()
                shard = shard.contiguous()
                # (form, body, lo, hi, obst rows, out window, rows of the window)
                forms = [("full", shard, ghost_lo, ghost_hi, m, slice(None), n)]
                if n > 1:
                    forms += [("bottom", shard[:, :1], ghost_lo, shard[:, 1:2], m[:3],
                               slice(0, 1), 1),
                              ("top", shard[:, -1:], shard[:, -2:-1], ghost_hi, m[-3:],
                               slice(n - 1, n), 1)]
                if n > 2:
                    forms.append(("interior", shard[:, 1:-1], shard[:, :1], shard[:, -1:],
                                  m[1:-1], slice(1, n - 1), n - 2))
                for form, body, lo, hi, ob, win, rows in forms:
                    for where in wheres + (("first", "last") if (n, nx) in i16_edges else ()):
                        off = offset(rows, where, p)
                        new = torch.zeros_like(shard)
                        tots = torch.zeros(2, dtype=torch.float32, device=dev)
                        fused_cuda.bind_slab_step(p, body, lo, hi, ob.contiguous(),
                                                  new[:, win], tots, off, storage)(1)
                        ref, ref_tot = fused_cuda.slab_plain(body, lo, hi, ob, p, off,
                                                             storage)
                        e = held(f"{kern} n={n} nx={nx} {start} {form} driven={where}",
                                 new[:, win], tots[1:], ref, ref_tot.reshape(1))
                        err[kern] = max(err[kern], e)
                        cases[kern] += 1
    # Ghosts, body and output as windows of one tensor whose plane 8 starts
    # beyond 2^31 elements.
    for nx in (64, 65):
        p, f, m = field(9, nx, "mixed")
        rows = -(-(2**28) // nx)
        big = torch.zeros((9, rows, nx), dtype=torch.int16, device=dev)
        big[:, :11] = quant.quantize(f, p.density)
        body, lo, hi, out = big[:, 1:10], big[:, :1], big[:, 10:11], big[:, rows - 9:]
        for where in wheres + ("first", "last"):
            off = offset(9, where, p)
            tots = torch.zeros(2, dtype=torch.float32, device=dev)
            fused_cuda.bind_slab_step(p, body, lo, hi, m, out, tots, off, "i16")(1)
            ref, ref_tot = fused_cuda.slab_plain(body, lo, hi, m, p, off, "i16")
            e = held(f"K1-slab-i16 n=9 nx={nx} planes {rows * nx} apart driven={where}", out,
                     tots[1:], ref, ref_tot.reshape(1))
            err["K1-slab-i16"] = max(err["K1-slab-i16"], e)
            cases["K1-slab-i16"] += 1
        del big, body, lo, hi, out
    for n, nx in ((256, 1024), (13, 100), (8, 1024), (30, 129)):
        grid = _build.load().lbm_ghosted_grid(n, nx, dev.index)
        plan = ghosted_cuda.shard_plan(n, nx, grid)
        split = [s // nx for s, _, _, _ in plan[0] if s % nx]  # rows two bands share
        for start in ("rest", "mixed"):
            p, f, m = field(n, nx, start)
            body, lo, hi = f[:, 1:-1].contiguous(), f[:, :1], f[:, -1:]
            for chunk in (1, 2, 3, 8) + ((256,) if start == "mixed" else ()):
                for where in wheres + ("first", "last") + (("split",) if split else ()):
                    off = (p.accel_row - split[len(split) // 2] if where == "split"
                           else offset(n, where, p))
                    band_cover(k6_paths, plan, nx, p.accel_row - off)
                    # Two chunks, the second through the launcher the first's
                    # result asks for (the parity: no closing copy).
                    a, b = body.clone(), torch.empty_like(body)
                    tots = torch.zeros(2 * chunk + 1, dtype=torch.float32, device=dev)
                    fwd = ghosted_cuda.bind_chunk(p, a, lo, hi, m, b, tots, off, chunk)
                    bwd = ghosted_cuda.bind_chunk(p, b, lo, hi, m, a, tots, off, chunk)
                    nxt = bwd if fwd.result is b else fwd
                    fwd(1)
                    nxt(1 + chunk)
                    ref, ref_tot = ghosted_cuda.chunk_plain(body, lo, hi, m, p, off, 2 * chunk)
                    e = held(f"K6 {n}x{nx} {start} chunk={chunk} x 2 driven={where}",
                             nxt.result, tots[1:], ref, ref_tot)
                    err["K6"] = max(err["K6"], e)
                    cases["K6"] += 1
    return err, cases


CA_SHAPES = ((256, 1024), (1024, 4096), (8, 1024), (13, 1024), (64, 100), (24, 99))


def ca_kernel_checks(dev, k8_paths: set,
                     k7_paths: set) -> tuple[dict[str, float], dict[str, int]]:
    """Phase 3g: the ca engines against the plain ca sweep
    (``fused_torch.ca_sweep``): K4-slab and K4-slab-i16 (int16 quantized once
    per sweep), K7 (f32, where two copies of the extended slab fit its L2
    budget) and K8 and K8-i16 (quantized every step), on shards of
    ``CA_SHAPES`` (256x1024 and 1024x4096: the shards of the 1024^2 and
    4096^2 runs over 4; 8 and 13 rows; nx = 100 and 99) at K in {2, 3, 4, 8},
    the driven row in the body, the lower or upper ghosts and none (K4-slab
    also in the first and the last row of its first tile's region), from
    rest and
    from a seeded perturbation with the injection guard false at every third
    cell.  Fields (int16 too) bitwise, tot_u within rtol 1e-6.  Returns the
    largest |diff| per kernel and the number of cases, and adds to
    ``k8_paths`` and ``k7_paths`` where K8's and K7's cases put the driven
    row in the blocks' bands (:func:`band_cover`)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import _build, ca_cuda, fused_torch, quant, temporal_cuda
    from lbm_tpu_torch.params import LBMParams

    kernels = {"K4-slab": (temporal_cuda.bind_slab_sweep, "f32", "sweep"),
               "K4-slab-i16": (temporal_cuda.bind_slab_sweep, "i16", "sweep"),
               "K7": (ca_cuda.bind_resident, "f32", "step"),
               "K8": (ca_cuda.bind_inplace, "f32", "step"),
               "K8-i16": (ca_cuda.bind_inplace, "i16", "step")}
    err, cases = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0)
    for n, nx in CA_SHAPES:
        p = LBMParams(nx=nx, ny=max(1024, 4 * n), max_iters=1, reynolds_dim=10, density=0.1,
                      accel=0.01, omega=1.85)
        ar = p.accel_row
        for K in (2, 3, 4, 8):
            m = np.zeros((n + 2 * K, nx), dtype=bool)
            m[:, 0] = m[:, -1] = True
            m[::7, nx // 2] = True
            ob = torch.from_numpy(m).to(dev)
            for start in ("rest", "mixed"):
                f = lattice.equilibrium_rest(p.density, n + 2 * K, nx)
                if start == "mixed":
                    rng = np.random.default_rng(13 + n + nx + K)
                    f = f * (np.float32(1.0)
                             + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
                    w1, _ = lattice.accel_weights(p.density, p.accel)
                    f[3, :, ::3] = w1 * np.float32(0.5)
                x32 = torch.from_numpy(f).to(dev)
                # K4-slab also takes the driven row at the first and the last
                # row of its first tile's region (extended rows 0 and RH - 1).
                rh = temporal_cuda.region(K)[0]
                for where, off in (("body", ar - n // 2), ("lo", ar + 1 + (K - 1) // 2),
                                   ("hi", ar - n - K // 2), ("none", K), ("first", ar + K),
                                   ("last", ar + K - (rh - 1) % (n + 2 * K))):
                    plain = {}
                    for name, (bind, storage, quantize) in kernels.items():
                        if name == "K7" and not ca_cuda.supports_resident(n, nx, K):
                            continue
                        if where in ("first", "last") and not name.startswith("K4-slab"):
                            continue
                        x = quant.quantize(x32, p.density) if storage == "i16" else x32
                        lo, body, hi = (x[:, :K].clone(), x[:, K:K + n].contiguous(),
                                        x[:, K + n:].clone())
                        if (storage, quantize) not in plain:
                            plain[(storage, quantize)] = fused_torch.ca_sweep(
                                lo, body, hi, ob, p, off % p.ny, p.ny, storage, quantize)
                        ref, ref_tot = plain[(storage, quantize)]
                        out = torch.zeros_like(body)
                        tots = torch.zeros(K + 1, dtype=torch.float32, device=dev)
                        extra = {} if name == "K7" else {"storage": storage}
                        bind(p, lo, body, hi, ob, out, tots, off % p.ny, p.ny, **extra)(1)
                        e = float((out.double() - ref.double()).abs().max())
                        what = f"{name} {n}x{nx} K={K} {start} driven={where}"
                        if not torch.equal(out, ref):
                            fail(f"{what}: fields differ from the plain version (max |diff| {e:.3e})")
                        if not torch.allclose(tots[1:], ref_tot, rtol=1e-6, atol=0.0):
                            fail(f"{what}: tot_u {tots[1:].tolist()} vs plain {ref_tot.tolist()}")
                        err[name] = max(err[name], e)
                        cases[name] += 1
                        ext = n + 2 * K
                        drow = ca_cuda.driven_ext_row(ar, off % p.ny, K, n, p.ny)
                        if name.startswith("K8"):
                            grid = _build.load().lbm_ca_inplace_grid(
                                ext, nx, int(storage == "i16"), dev.index)
                            band_cover(k8_paths, ca_cuda.sweep_plan(ext, nx, K, grid), nx, drow)
                        elif name == "K7":
                            grid = ca_cuda.resident_grid(
                                _build.load().lbm_ca_resident_grid(ext, nx, dev.index), n, nx)
                            band_cover(k7_paths, ca_cuda.resident_plan(ext, nx, K, grid), nx,
                                       drow)
    return err, cases


# Phase 3h's pinned parts (ny, nx, R, S, K): 2 and 3 parts, 3 parts in 3
# slots, 8 parts of the 2048^2 grid in 2 slots; each with the driven row at
# ny - 2, in part 1's body and part 0's upper ghosts (R + 1), in part 0's
# body and part 1's lower ghosts (R - 1), and in row 0 (the last part's
# upper ghosts across the wrap).
HBM_PINNED = ((96, 128, 48, 2, 4), (96, 128, 32, 2, 4), (96, 128, 32, 3, 4),
              (2048, 2048, 256, 2, 4))


def hbm_kernel_checks(dev) -> tuple[float, int]:
    """Phase 3h: K9 (the HBM-parts sweep, one launch per sweep) over 2K + 1
    steps (two sweeps and a K1 tail) against its plain version (K twin steps
    per sweep) and against the K1 loop, at 2048x2048 and 60x100 on the
    plan's parts, K in {2, 3, 4, 8}, rest and perturbed starts; then on
    :data:`HBM_PINNED`'s parts and slots, the driven row in each place, a
    second run bitwise equal to the first: fields equal, tot_u within rtol
    1e-6, one launch per sweep.  Returns the largest |diff| and the number
    of cases."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_cuda, hbm_cuda
    from lbm_tpu_torch.params import with_driven_row

    worst, n_cases = 0.0, 0
    for ny, nx in ((2048, 2048), (60, 100)):
        p, m = box_scene(ny, nx, 0.01 if ny >= 1024 else 0.005)
        obst = torch.from_numpy(m).to(dev)
        for start in ("rest", "mixed"):
            f0 = (mixed_state(p, dev) if start == "mixed"
                  else lattice.equilibrium_rest_device(p.density, p.ny, p.nx, dev))
            for K in (2, 3, 4, 8):
                steps = 2 * K + 1
                f_k, tot_k = (t.clone() for t in hbm_cuda.make_run_all(p, obst, steps, K)(f0))
                f_p, tot_p = hbm_cuda.run_plain(f0, obst, p, steps, K)
                e, _ = compare(f"K9 {ny}x{nx} K={K} {start}", f_k, tot_k, f_p, tot_p)
                f_1, tot_1 = fused_cuda.make_run_all(p, obst, steps)(f0)
                compare(f"K9 vs K1 {ny}x{nx} K={K} {start}", f_k, tot_k, f_1, tot_1)
                worst, n_cases = max(worst, e), n_cases + 1
    for ny, nx, R, S, K in HBM_PINNED:
        p0, m = box_scene(ny, nx, 0.01 if ny >= 1024 else 0.005)
        obst = torch.from_numpy(m).to(dev)
        for row in (ny - 2, R + 1, R - 1, 0):
            p = with_driven_row(p0, row)
            f0 = mixed_state(p, dev)
            steps = 2 * K + 1
            what = f"K9 {ny}x{nx} R={R} S={S} K={K} driven row {row}"
            run = hbm_cuda.make_run_all(p, obst, steps, K, rows=R, slots=S)
            before = hbm_cuda.LAUNCHES
            f_k, tot_k = (t.clone() for t in run(f0))
            if hbm_cuda.LAUNCHES != before + 2:
                fail(f"{what}: {hbm_cuda.LAUNCHES - before} launches for 2 sweeps")
            f_p, tot_p = hbm_cuda.run_plain(f0, obst, p, steps, K)
            e, _ = compare(what, f_k, tot_k, f_p, tot_p)
            f_2, tot_2 = run(f0)
            if not (torch.equal(f_2, f_k) and torch.equal(tot_2, tot_k)):
                fail(f"{what}: a second run differs from the first")
            worst, n_cases = max(worst, e), n_cases + 1
    return worst, n_cases


# Phase 3i's grids.  512^2 and 1024^2 keep the scene's driven row; 1024^2 is
# K10's main path (5l): 64 row blocks, its copies in HBM, 2048 tiles of 16
# rows x 32 columns, two warps a tile (8 rows each); the smaller grids
# split a tile's rows over eight warps.
BLOCKED_GRIDS = ((128, 128), (256, 256), (512, 512), (1024, 1024), (72, 100))


def blocked_kernel_checks(dev) -> tuple[float, int]:
    """Phase 3i: K10 (csrc/blocked.cu) against its plain version
    (``fused_torch.blocked_chunk``) on ``BLOCKED_GRIDS`` (72x100: any nx,
    row blocks of 16 with a partial last one), with the driven row in the
    first row block, a middle one, on a block edge (the last row of one
    block, the first of the next) and in the last (its place in the scene,
    ny - 2; the only place at 512x512 and 1024x1024), (steps, chunk) in
    {(7, 4), (8, 8), (5, 5)} (odd and even chunks; 1024x1024: (7, 4) and
    (5, 5)), from rest and from the perturbed state (1024x1024: perturbed);
    256 steps in one 256-step chunk at 128x128 (the main path's chunk: its
    256-row column-sum pass); then K10 against K2 at 512x512 over 256
    steps.  Fields and tot_u torch.equal: the plain version takes K10's
    grouping of the |u| sums.  Returns the largest |diff| and the number of
    cases."""
    import torch

    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import blocked_cuda, resident_cuda
    from lbm_tpu_torch.params import with_driven_row

    def check(name, p, obst, f0, steps, chunk):
        f_k, tot_k = (t.clone() for t in blocked_cuda.make_run_all(
            p, obst, steps, chunk=chunk)(f0))
        f_p, tot_p = blocked_cuda.run_plain(f0, obst, p, steps)
        e, r = compare(f"K10 {name} steps={steps} chunk={chunk}", f_k, tot_k, f_p, tot_p)
        if not torch.equal(tot_k, tot_p):
            fail(f"K10 {name} steps={steps} chunk={chunk}: tot_u off the plain version's "
                 f"grouping by {r:.3e} relative")
        return e

    B = blocked_cuda.DEFAULT_BLOCK_ROWS
    worst, n_cases = 0.0, 0
    for ny, nx in BLOCKED_GRIDS:
        p0, m = box_scene(ny, nx)
        obst = torch.from_numpy(m).to(dev)
        mid = (ny // B // 2) * B + 3
        big = ny >= 512  # the slowest plain versions
        for row in (ny - 2,) if big else (1, mid, 2 * B - 1, 2 * B, ny - 2):
            p = with_driven_row(p0, row)
            starts = ("mixed",) if ny == 1024 or row != ny - 2 else ("rest", "mixed")
            for start in starts:
                f0 = (mixed_state(p, dev) if start == "mixed"
                      else lattice.equilibrium_rest_device(p.density, ny, nx, dev))
                for steps, chunk in ((7, 4), (5, 5)) if ny == 1024 else ((7, 4), (8, 8), (5, 5)):
                    e = check(f"{ny}x{nx} driven row {row} {start}", p, obst, f0, steps, chunk)
                    worst, n_cases = max(worst, e), n_cases + 1
    p, m = box_scene(128, 128)
    e = check("128x128 mixed", p, torch.from_numpy(m).to(dev), mixed_state(p, dev), 256, 256)
    worst, n_cases = max(worst, e), n_cases + 1
    p, m = box_scene(512, 512)
    obst = torch.from_numpy(m).to(dev)
    f0 = mixed_state(p, dev)
    f_k, tot_k = (t.clone() for t in blocked_cuda.make_run_all(p, obst, 256)(f0))
    f_2, _ = resident_cuda.make_run_all(p, obst, 256)(f0)
    if not torch.equal(f_k, f_2):
        fail(f"K10 vs K2 512x512 256 steps: fields differ (max |diff| "
             f"{float((f_k - f_2).abs().max()):.3e})")
    return worst, n_cases


def build_native_writer() -> str:
    """Build the C++ writer of final_state.dat (``make native``, into the
    gitignored native/build/), so that the large-grid CLI runs do not format
    millions of lines in Python.  Without make or a compiler the Python
    writer runs: slower, same bytes."""
    from lbm_tpu_torch.io import native

    root = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run(["make", "-C", root, "native"], capture_output=True, text=True,
                              timeout=120)
        built = proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        built = False
    return "C++ writer" if built and native.available() else "Python writer (make native failed)"


# The forcing variables a plan reads (phase (b) sets each as its run did).
FORCING = ("LBM_RESIDENT_KIND", "LBM_TEMPORAL_IMPL", "LBM_CA_ENGINE", "LBM_CA_PARTS")


@contextlib.contextmanager
def temporal_impl(impl: str | None):
    """LBM_TEMPORAL_IMPL set to ``impl`` (unset for None) inside the block."""
    old = os.environ.pop("LBM_TEMPORAL_IMPL", None)
    if impl is not None:
        os.environ["LBM_TEMPORAL_IMPL"] = impl
    try:
        yield
    finally:
        os.environ.pop("LBM_TEMPORAL_IMPL", None)
        if old is not None:
            os.environ["LBM_TEMPORAL_IMPL"] = old


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    import numpy as np

    from lbm_tpu_torch import cli
    from lbm_tpu_torch.core import lattice, oracle
    from lbm_tpu_torch.io import load_scene
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.models.driver import RunConfig, run_simulation
    from lbm_tpu_torch.io.writers import read_av_vels
    from lbm_tpu_torch.ops import (
        _build,
        blocked_cuda,
        ca_cuda,
        fused_cuda,
        ghosted_cuda,
        hbm_cuda,
        inplace_cuda,
        quant,
        resident_cuda,
        skew_cuda,
        temporal_cuda,
    )
    from lbm_tpu_torch.params import LBMParams
    from lbm_tpu_torch.tools import bench, dryrun, kernel_times, pod, scenegen, verify_device

    dev = torch.device("cuda", 0)
    card = bench.card_line()
    if card is None:
        fail("nvidia-smi is missing: cannot name the card")
    device_kind = torch.cuda.get_device_name(0)

    # Phase 1: card, versions, build.
    print(card)
    t_start = t0 = time.perf_counter()

    def elapsed() -> str:
        return f" | {time.perf_counter() - t_start:.1f} s elapsed"

    _build.load()
    build_s = time.perf_counter() - t0
    writer = build_native_writer()
    regs = [ln.strip() for ln in (_build.build_dir() / "nvcc.log").read_text().splitlines()
            if "registers" in ln]
    print(f"[1 build] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| kernels built in {build_s:.2f} s | final_state.dat: {writer} | ptxas: "
          f"{'; '.join(regs)}")

    def field(ny, nx, accel=0.005):
        p, m = box_scene(ny, nx, accel)
        return p, m, torch.from_numpy(m).to(dev), lattice.equilibrium_rest_device(
            p.density, ny, nx, dev)

    # Phase 2: K1 vs plain.
    k1_err, k1_rel, notes = 0.0, 0.0, []
    for ny, nx, start in ((1024, 1024, "rest"), (1536, 1536, "rest"), (1536, 1536, "mixed"),
                          (2048, 2048, "rest"), (2048, 2048, "mixed"), (60, 100, "rest"),
                          (60, 100, "mixed")):
        p, _, obst, f0 = field(ny, nx, 0.01 if ny >= 1024 else 0.005)
        if start == "mixed":
            f0 = mixed_state(p, dev)
        f_k, tot_k = fused_cuda.make_run_all(p, obst, 50)(f0)
        f_p, tot_p = fused_cuda.run_plain(f0, obst, p, 50)
        e, r = compare(f"K1 {ny}x{nx} {start}", f_k, tot_k, f_p, tot_p)
        k1_err, k1_rel = max(k1_err, e), max(k1_rel, r)
        notes.append(f"{ny}x{nx} {start} start: equal, tot_u rel {r:.2e}")
    print(f"[2 K1 vs plain] card: {card} | 50 steps | " + "; ".join(notes))

    # Phase 3: K2 vs plain.  k2_paths: where the driven row sits in the
    # blocks' bands (the band plan on the card's grid, csrc/two_copy.cuh).
    k2_err, k2_rel, n_cases = 0.0, 0.0, 0
    k2_paths: set = set()

    def k2_case(name, p, obst, f0, steps, chunk):
        nonlocal k2_err, k2_rel, n_cases
        grid = _build.load().lbm_resident_grid(p.ny, p.nx, dev.index)
        band_cover(k2_paths, resident_cuda.grid_plan(p.ny, p.nx, grid), p.nx, p.accel_row)
        f_k, tot_k = resident_cuda.make_run_all(p, obst, steps, chunk=chunk)(f0)
        f_p, tot_p = resident_cuda.run_plain(f0, obst, p, steps)
        e, r = compare(f"K2 {name} steps={steps} chunk={chunk}", f_k, tot_k, f_p, tot_p)
        k2_err, k2_rel = max(k2_err, e), max(k2_rel, r)
        n_cases += 1

    for ny, nx in ((128, 128), (256, 128), (256, 256)):
        p, _, obst, f0 = field(ny, nx)
        for steps, chunk in ((7, 4), (8, 4), (5, 8), (600, 256)):
            k2_case(f"{ny}x{nx}", p, obst, f0, steps, chunk)
    k2_case("256x256 mixed start", p, obst, mixed_state(p, dev), 600, 256)
    for ny, nx in K2_EDGES:
        p, _, obst, _ = field(ny, nx)
        f0 = mixed_state(p, dev)
        for chunk in (1, 2, 3, 8, 256):
            k2_case(f"{ny}x{nx} mixed start", p, obst, f0, 2 * chunk + 1, chunk)
    if not {"first", "last", "split rows"} <= k2_paths:
        fail(f"K2's cases put the driven row only at {sorted(k2_paths)} of the bands")
    print(f"[3 K2 vs plain] card: {card} | {n_cases} cases (128x128, 256x128, 256x256 "
          f"x (7,4) (8,4) (5,8) (600,256); 256x256 mixed start 600 steps; "
          f"{', '.join(f'{a}x{b}' for a, b in K2_EDGES)} mixed x chunks 1, 2, 3, 8, 256, "
          f"2 chunks + 1 step): fields equal, tot_u max rel {k2_rel:.2e}; the driven row on a "
          f"band's {' and '.join(sorted(k2_paths))}")

    # Phase 3b: K3 vs plain, and K3 vs K1 at full length.  k3_paths: where
    # the driven row sits in the blocks' bands, over every K3 and K3-i16
    # case of 3b and 3c (csrc/aa_inplace.cuh).
    k3_err, k3_rel, n_cases = 0.0, 0.0, 0
    k3_paths: set = set()

    def k3_cover(p, storage="f32"):
        grid = _build.load().lbm_inplace_grid(p.ny, p.nx, int(storage == "i16"), dev.index)
        band_cover(k3_paths, inplace_cuda.band_plan([(0, p.ny)], p.nx, grid, p.ny), p.nx,
                   p.accel_row)

    for ny, nx in ((1024, 1024), (1021, 1023)):
        for start in ("rest", "mixed"):
            p, _, obst, f0 = field(ny, nx, 0.01)
            k3_cover(p)
            if start == "mixed":
                f0 = mixed_state(p, dev)
            f_k, tot_k = inplace_cuda.make_run_all(p, obst, 200)(f0)
            f_p, tot_p = inplace_cuda.run_plain(f0, obst, p, 200)
            e, r = compare(f"K3 {ny}x{nx} {start}", f_k, tot_k, f_p, tot_p)
            k3_err, k3_rel = max(k3_err, e), max(k3_rel, r)
    for ny, nx in ((60, 100), (7, 33), (45, 99)):
        p, _, obst, _ = field(ny, nx)
        k3_cover(p)
        f0 = mixed_state(p, dev)
        for steps, chunk in ((7, 4), (8, 4), (5, 8), (600, 256)):
            f_k, tot_k = inplace_cuda.make_run_all(p, obst, steps, chunk=chunk)(f0)
            f_p, tot_p = inplace_cuda.run_plain(f0, obst, p, steps)
            e, r = compare(f"K3 {ny}x{nx} steps={steps} chunk={chunk}", f_k, tot_k, f_p, tot_p)
            k3_err, k3_rel = max(k3_err, e), max(k3_rel, r)
            n_cases += 1
    p, _, obst, f0 = field(1024, 1024, 0.01)
    f_k, tot_k = inplace_cuda.make_run_all(p, obst, 20000)(f0)
    f_k, tot_k = f_k.clone(), tot_k.clone()
    f_1, tot_1 = fused_cuda.make_run_all(p, obst, 20000)(f0)
    _, k3_k1_rel = compare("K3 vs K1 1024x1024 20000 steps", f_k, tot_k, f_1, tot_1)
    print(f"[3b K3 vs plain] card: {card} | 1024x1024 and 1021x1023 rest and perturbed, 200 "
          f"steps; {n_cases} cases (60x100, 7x33, 45x99 x (7,4) (8,4) (5,8) (600,256), "
          f"perturbed start): fields equal, tot_u max rel {k3_rel:.2e} | "
          f"K3 vs K1 1024x1024 x 20000 steps: fields equal, tot_u max rel {k3_k1_rel:.2e}")

    # Phase 3c: the int16 kernels vs plain, and K3-i16 vs K1-i16 at full length.
    def i16_start(p, f):
        return quant.quantize(f, p.density)

    k1i_err, k1i_rel = 0.0, 0.0
    for n in (1024, 1536, 2048):
        for start in ("rest", "mixed"):
            p, _, obst, f0 = field(n, n, 0.01)
            q0 = i16_start(p, f0 if start == "rest" else mixed_state(p, dev))
            q_k, tot_k = fused_cuda.make_run_all(p, obst, 50, "i16")(q0)
            q_p, tot_p = fused_cuda.run_plain(q0, obst, p, 50, "i16")
            e, r = compare(f"K1-i16 {n}x{n} {start}", q_k, tot_k, q_p, tot_p)
            k1i_err, k1i_rel = max(k1i_err, e), max(k1i_rel, r)
    for ny, nx in K1_I16_EDGES:
        p, _, obst, _ = field(ny, nx)
        q0 = i16_start(p, mixed_state(p, dev))
        q_k, tot_k = fused_cuda.make_run_all(p, obst, 9, "i16")(q0)
        q_p, tot_p = fused_cuda.run_plain(q0, obst, p, 9, "i16")
        e, r = compare(f"K1-i16 {ny}x{nx} (driven row {p.accel_row % 8} of a block's 8)", q_k,
                       tot_k, q_p, tot_p)
        k1i_err, k1i_rel = max(k1i_err, e), max(k1i_rel, r)
    # 9 ny nx just above 2^31: K1-i16's long long offsets, from a seeded
    # 64-row field repeated down the grid.
    wide_p, wide_mask = box_scene(16384, 14564, 0.005)
    wide_obst = torch.from_numpy(wide_mask).to(dev)
    band, _ = box_scene(64, 14564, 0.005)
    wide_q0 = i16_start(wide_p, mixed_state(band, dev)).repeat(1, 16384 // 64, 1)
    q_k, tot_k = fused_cuda.make_run_all(wide_p, wide_obst, 2, "i16")(wide_q0)
    q_p, tot_p = fused_cuda.run_plain(wide_q0, wide_obst, wide_p, 2, "i16")
    e, r = compare("K1-i16 16384x14564 (long long offsets)", q_k, tot_k, q_p, tot_p)
    k1i_err, k1i_rel = max(k1i_err, e), max(k1i_rel, r)
    del wide_q0, wide_obst, wide_mask, q_k, q_p
    torch.cuda.empty_cache()
    k3i_err, k3i_rel, n_cases = 0.0, 0.0, 0
    for n in (256, 1024, 1536):
        for start in ("rest", "mixed"):
            p, _, obst, f0 = field(n, n, 0.01)
            k3_cover(p, "i16")
            q0 = i16_start(p, f0 if start == "rest" else mixed_state(p, dev))
            q_k, tot_k = inplace_cuda.make_run_all(p, obst, 200, storage="i16")(q0)
            q_p, tot_p = inplace_cuda.run_plain(q0, obst, p, 200, "i16")
            e, r = compare(f"K3-i16 {n}x{n} {start}", q_k, tot_k, q_p, tot_p)
            k3i_err, k3i_rel = max(k3i_err, e), max(k3i_rel, r)
    for ny, nx in ((60, 100), (7, 33), (45, 99), (256, 256)):
        p, _, obst, _ = field(ny, nx)
        k3_cover(p, "i16")
        q0 = i16_start(p, mixed_state(p, dev))
        for steps, chunk in ((7, 4), (8, 4), (5, 8), (600, 256))[3 if ny == 256 else 0:]:
            q_k, tot_k = inplace_cuda.make_run_all(p, obst, steps, chunk=chunk,
                                                   storage="i16")(q0)
            q_p, tot_p = inplace_cuda.run_plain(q0, obst, p, steps, "i16")
            e, r = compare(f"K3-i16 {ny}x{nx} steps={steps} chunk={chunk}", q_k, tot_k, q_p,
                           tot_p)
            k3i_err, k3i_rel = max(k3i_err, e), max(k3i_rel, r)
            n_cases += 1
    p, _, obst, f0 = field(1024, 1024, 0.01)
    q0 = i16_start(p, f0)
    q_k, tot_k = inplace_cuda.make_run_all(p, obst, 20000, storage="i16")(q0)
    q_k, tot_k = q_k.clone(), tot_k.clone()
    q_1, tot_1 = fused_cuda.make_run_all(p, obst, 20000, "i16")(q0)
    _, k3i_k1i_rel = compare("K3-i16 vs K1-i16 1024x1024 20000 steps", q_k, tot_k, q_1, tot_1)
    if not {"first", "last", "split rows"} <= k3_paths:
        fail(f"3b/3c: the driven row and the K3 bands reached only {sorted(k3_paths)}")
    print(f"[3c i16 kernels vs plain] card: {card} | K1-i16 1024x1024, 1536x1536 and "
          f"2048x2048 x 50 steps, rest and perturbed, and "
          + ", ".join(f"{ny}x{nx}" for ny, nx in K1_I16_EDGES)
          + f" x 9 steps perturbed, 16384x14564 x 2 (long long offsets): int16 fields equal, "
          f"tot_u max rel {k1i_rel:.2e} | "
          f"K3-i16 256x256, 1024x1024 and 1536x1536 x 200 steps, rest and "
          f"perturbed, + {n_cases} chunked cases (60x100, 7x33, 45x99, 256x256): int16 fields "
          f"equal, tot_u max rel {k3i_rel:.2e} | K3-i16 vs K1-i16 1024x1024 x 20000 steps: "
          f"int16 fields equal, tot_u max rel {k3i_k1i_rel:.2e} | K3's bands: the driven row "
          f"as {sorted(k3_paths)}")

    # Phase 3d: the sweep kernels vs their plain version (one plain run per
    # case serves both kernels: K4 and K5 compute the same K-step sweeps).
    sweep_mods = (("K4", temporal_cuda), ("K5", skew_cuda))
    # max |diff| per (kernel, grid, K), over both starts: the kernels line
    # reports each timed configuration's own case.
    sweep_err: dict[tuple[str, int, int, int], float] = {}
    sweep_rel, n_cases = 0.0, 0
    # K4's paths (csrc/temporal.cu): the rows a tile's region takes
    # the driven row at, the tile counts against the persistent grid, and
    # the copies its region rows take, over every K4 case.
    k4_paths: dict[str, set] = {"driven": set(), "tiles": set(), "copies": set()}
    ny_last = last_row_ny(temporal_cuda)
    for ny, nx in ((1024, 1024), (1536, 1536), (2048, 2048), (1000, 1500), (4096, 4096),
                   (ny_last, 1499), (60, 100)):
        p, _, obst, f0 = field(ny, nx, 0.01)
        for K in SWEEP_DEPTHS:
            k4_cover(k4_paths, temporal_cuda, ny, nx, K, p.accel_row)
        for start in ("rest", "mixed"):
            s32 = f0 if start == "rest" else mixed_state(p, dev)
            for storage in ("f32", "i16"):
                sfx = "-i16" if storage == "i16" else ""
                s0 = i16_start(p, s32) if storage == "i16" else s32
                for K in SWEEP_DEPTHS:
                    steps = 2 * K if ny == 4096 else (50 if 50 % K else 51)
                    f_p, tot_p = temporal_cuda.run_plain(s0, obst, p, steps, K, storage)
                    for name, mod in sweep_mods:
                        f_k, tot_k = mod.make_run_all(p, obst, steps, K, storage)(s0)
                        e, r = compare(f"{name}{sfx} {ny}x{nx} K={K} {steps} steps {start}",
                                       f_k, tot_k, f_p, tot_p)
                        key = (name + sfx, ny, nx, K)
                        sweep_err[key] = max(sweep_err.get(key, 0.0), e)
                        sweep_rel = max(sweep_rel, r)
                        n_cases += 1
    # K5 at the shapes its walk makes hard (k5_hard_shapes): the driven row
    # on the first and the last of a walk step's R rows at every level, and
    # every width of level-0 copy.
    k5_paths: dict[str, set] = {"driven": set(), "copies": set()}
    k5_cases = 0
    for K in SWEEP_DEPTHS:
        for ny, nx, bh in k5_hard_shapes(K):
            p, _, obst, f0 = field(ny, nx)
            k5_paths["driven"] |= {(K,) + d for d in skew_cuda.driven_positions(ny, K, bh)}
            strip_band = (skew_cuda.strip_width(K), bh)
            for start in ("rest", "mixed"):
                s32 = f0 if start == "rest" else mixed_state(p, dev)
                for storage in ("f32", "i16"):
                    k5_paths["copies"].add(f"{storage} {skew_cuda.copy_bytes(nx, storage)}")
                    s0 = i16_start(p, s32) if storage == "i16" else s32
                    f_p, tot_p = skew_cuda.run_plain(s0, obst, p, 2 * K + 1, K, storage)
                    f_k, tot_k = skew_cuda.make_run_all(p, obst, 2 * K + 1, K, storage,
                                                        strip_band=strip_band)(s0)
                    _, r = compare(f"K5 {storage} {ny}x{nx} K={K} band {bh} {start}", f_k,
                                   tot_k, f_p, tot_p)
                    sweep_rel = max(sweep_rel, r)
                    k5_cases += 1
    want = {(K, lv, i) for K in SWEEP_DEPTHS for lv in range(1, K + 1)
            for i in range(skew_cuda.ROWS_PER_STEP)}
    if not want <= k5_paths["driven"]:
        fail(f"3d: K5's driven row missed {sorted(want - k5_paths['driven'])}")
    if not {"f32 16", "f32 8", "f32 4", "i16 16", "i16 8", "i16 4", "i16 0"} <= k5_paths["copies"]:
        fail(f"3d: K5's copy widths reached: {sorted(k5_paths['copies'])}")
    rh = temporal_cuda.region(4)[0]
    if not {0, rh - 1} <= k4_paths["driven"]:
        fail(f"3d: the driven row sat only at region rows {sorted(k4_paths['driven'])}")
    if not {"fewer", "ragged"} <= k4_paths["tiles"]:
        fail(f"3d: tile counts against the persistent grid: {sorted(k4_paths['tiles'])}")
    if not {"elements", "quads", "floats", "int16 odd element"} <= k4_paths["copies"]:
        fail(f"3d: K4's copy paths reached: {sorted(k4_paths['copies'])}")
    print(f"[3d sweep kernels vs plain] card: {card} | K4, K5, K4-i16, K5-i16 at 1024x1024, "
          f"1536x1536, 2048x2048, 1000x1500, {ny_last}x1499, 60x100 x K in {SWEEP_DEPTHS} x "
          f"50 steps (51 at K=2) and 4096x4096 x 2K steps, rest and perturbed: {n_cases} "
          f"cases, fields equal (int16 too), tot_u max rel {sweep_rel:.2e} | K4's paths: the "
          f"driven row at region rows {sorted(k4_paths['driven'])} of {rh}, tile counts "
          f"{sorted(k4_paths['tiles'])} of the persistent grid, copies "
          f"{sorted(k4_paths['copies'])} | K5 at its hard shapes (bands of 3 to 2K rows, nx "
          f"20 to 100, ny 2K): {k5_cases} cases, fields equal; the driven row at both of a "
          f"walk step's {skew_cuda.ROWS_PER_STEP} rows at every level, copies "
          f"{sorted(k5_paths['copies'])} bytes")

    # Phase 3e: the sweeps against K1 at full length, and the two int16
    # sweeps against each other (each quantizes once per sweep).
    long_steps, long_k = 8000, 4
    p, _, obst, f0 = field(2048, 2048, 0.01)
    f_1, tot_1 = (t.clone() for t in fused_cuda.make_run_all(p, obst, long_steps)(f0))
    long_rel = []
    for name, mod in sweep_mods:
        f_k, tot_k = mod.make_run_all(p, obst, long_steps, long_k)(f0)
        _, r = compare(f"{name} vs K1 2048x2048 {long_steps} steps", f_k, tot_k, f_1, tot_1)
        long_rel.append(f"{name} vs K1 tot_u max rel {r:.2e}")
    q0 = i16_start(p, f0)
    q_4, tot_4 = (t.clone() for t in
                  temporal_cuda.make_run_all(p, obst, long_steps, long_k, "i16")(q0))
    q_5, tot_5 = skew_cuda.make_run_all(p, obst, long_steps, long_k, "i16")(q0)
    _, r = compare(f"K4-i16 vs K5-i16 2048x2048 {long_steps} steps", q_4, tot_4, q_5, tot_5)
    long_rel.append(f"K4-i16 vs K5-i16 int16 fields equal, tot_u max rel {r:.2e}")
    print(f"[3e sweeps at full length] card: {card} | 2048x2048 x {long_steps} steps, "
          f"K={long_k}: fields equal; {'; '.join(long_rel)}")

    # Phase 3f: the sharded modes' kernels vs their plain versions.
    k6_paths: set = set()
    slab_err, slab_cases = slab_kernel_checks(dev, k6_paths)
    if not {"first", "last", "split rows"} <= k6_paths:
        fail(f"3f: the driven row and the K6 bands reached only {sorted(k6_paths)}")
    print(f"[3f shard kernels vs plain] card: {card} | "
          + "; ".join(f"{k} {slab_cases[k]} cases, fields equal, max |diff| {slab_err[k]:.1e}"
                      for k in slab_err)
          + f" | K6's bands: the driven row as {sorted(k6_paths)}"
          + f" | {time.perf_counter() - t_start:.1f} s elapsed")

    # Phase 3g: the ca engines vs the plain ca sweep; 3h: K9 vs plain and K1.
    k8_paths: set = set()
    k7_paths: set = set()
    ca_err, ca_cases = ca_kernel_checks(dev, k8_paths, k7_paths)
    if not {"first", "last", "split rows"} <= k8_paths:
        fail(f"3g: the driven row and the K8 bands reached only {sorted(k8_paths)}")
    if not {"first", "last"} <= k7_paths:
        fail(f"3g: the driven row and the K7 bands reached only {sorted(k7_paths)}")
    print(f"[3g ca engines vs plain] card: {card} | shards "
          + ", ".join(f"{n}x{nx}" for n, nx in CA_SHAPES) + " x K in (2, 3, 4, 8), driven row in "
          "body / lo / hi / none (K4-slab: also the first and last region row), rest and "
          "perturbed | "
          + "; ".join(f"{k} {ca_cases[k]} cases, fields equal, max |diff| {ca_err[k]:.1e}"
                      for k in ca_err)
          + f" | K8's bands: the driven row as {sorted(k8_paths)}"
          + f" | K7's bands: the driven row as {sorted(k7_paths)}"
          + f" | {time.perf_counter() - t_start:.1f} s elapsed")
    k9_err, k9_cases = hbm_kernel_checks(dev)
    print(f"[3h K9 vs plain and K1] card: {card} | 2048x2048 and 60x100 x K in (2, 3, 4, 8) x "
          f"2K + 1 steps, rest and perturbed; (ny, nx, R, S, K) in {HBM_PINNED} x the driven "
          f"row at ny - 2, R + 1, R - 1 and 0, a second run bitwise: {k9_cases} cases, fields "
          f"equal to plain and to K1, one launch per sweep, max |diff| {k9_err:.1e}")
    k10_err, k10_cases = blocked_kernel_checks(dev)
    print(f"[3i K10 vs plain and K2] card: {card} | "
          + ", ".join(f"{ny}x{nx}" for ny, nx in BLOCKED_GRIDS)
          + f" x B={blocked_cuda.DEFAULT_BLOCK_ROWS}, driven row in the first / a middle / "
          "the last row block and on a block edge (512x512, 1024x1024: the last), (steps, "
          "chunk) (7,4) (8,8) (5,5) (1024x1024: (7,4) (5,5)), rest and perturbed, and 128x128 "
          f"x 256 steps in one chunk: {k10_cases} cases, fields and tot_u equal, max |diff| "
          f"{k10_err:.1e} | K10 vs K2 512x512 x 256 steps: fields equal{elapsed()}")

    # Phase 4: oracle anchor on the cuda main path.
    p128 = LBMParams(nx=128, ny=128, max_iters=120, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)
    scene128 = Scene(p128, scenegen.make_mask("cylinder", 128, 128))
    res = run_simulation(scene128, RunConfig(variant="cuda", device="cuda"))
    f_o, av_o = oracle.run(p128, scene128.obstacles, num_steps=120)
    f_dev = float(np.abs(res.f - f_o).max())
    av_rel = float(np.max(np.abs(res.av_vels - av_o) / np.abs(av_o)))
    if not (f_dev <= 2e-7 and av_rel <= 1e-4):
        fail(f"oracle anchor: max |df| {f_dev:.3e} (atol 2e-7), av rel {av_rel:.3e} (rtol 1e-4)")
    print(f"[4 oracle anchor] card: {card} | {res.variant} 128x128 cylinder, 120 steps: "
          f"max |df| {f_dev:.3e} <= 2e-7, av max rel {av_rel:.3e} <= 1e-4")

    # Phase 5: end to end through the CLI, in this process so the launch
    # counters of the main path can be read.
    mlups: dict[str, float] = {}
    launches: dict[str, int] = {}
    # Phase 5's runs that phase (b) plans again: (params, obstacles,
    # variant, extra flags, forcing variables, the run's Variant line, the
    # kernel its launch counters showed).
    plan_cases: list[tuple] = []
    run_texts: dict[str, str] = {}  # out_dir -> the run's stdout
    with tempfile.TemporaryDirectory() as td:

        def cli_run(tag, pfile, ofile, variant, *extra, out_dir=None):
            out_dir = out_dir or os.path.join(td, f"{tag}-{variant}{'-'.join(extra)}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["run", pfile, ofile, "--variant", variant, "--device", "cuda",
                               "--out-dir", out_dir, *extra])
            text = buf.getvalue()
            if rc != 0:
                fail(f"run {tag} --variant {variant} {' '.join(extra)} exited {rc}:\n{text}")
            rate = [ln for ln in text.splitlines() if ln.startswith("Compute rate:")]
            run_variant = [ln for ln in text.splitlines() if ln.startswith("Variant:")]
            mlups[f"{tag} {run_variant[0].split()[-1]}"] = float(rate[0].split()[-2])
            run_texts[out_dir] = text
            return out_dir, run_variant[0].split()[-1]

        def same_final_state(a, b):
            return filecmp.cmp(os.path.join(a, "final_state.dat"),
                               os.path.join(b, "final_state.dat"), shallow=False)

        def cli_check(ref_av, ref_fs, run_dir, what, tolerance=1.0):
            """``check`` a run's files against reference files (``tolerance``
            percent, the checker's default 1); returns the (av_vels,
            final_state) max deviations in percent as printed."""
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["check", "--ref-av-vels-file", ref_av,
                               "--ref-final-state-file", ref_fs,
                               "--av-vels-file", os.path.join(run_dir, "av_vels.dat"),
                               "--final-state-file", os.path.join(run_dir, "final_state.dat"),
                               "--tolerance", str(tolerance)])
            text = buf.getvalue()
            if rc != 0 or "Both tests passed!" not in text:
                fail(f"check {what} failed (rc {rc}):\n{text}")
            return [ln.split("=")[-1].strip() for ln in text.splitlines() if ln.endswith("%")]

        def scene_files(n, steps, preset, accel):
            params = LBMParams(nx=n, ny=n, max_iters=steps, reynolds_dim=10,
                               density=0.1, accel=accel, omega=1.85)
            return scenegen.write_scene(td, preset, params)

        runs = [("256x256", *scene_files(256, 4400, "cylinder", 0.005)),
                ("1024x1024", *scene_files(1024, 2000, "channel", 0.01))]
        resident_cuda.LAUNCHES = 0
        inplace_cuda.LAUNCHES = 0
        inplace_cuda.LAUNCHES_I16 = 0
        cuda_runs = {tag: cli_run(tag, pf, of, "cuda") for tag, pf, of in runs}
        i16_dir, i16_variant = cli_run("256x256", *runs[0][1:], "cuda", "--storage", "i16")
        launches["K2"], k3_cli = resident_cuda.LAUNCHES, inplace_cuda.LAUNCHES
        launches["K3-i16"] = inplace_cuda.LAUNCHES_I16
        if launches["K2"] <= 0 or k3_cli <= 0 or launches["K3-i16"] <= 0:
            fail(f"main path skipped a kernel: K2 launches {launches['K2']}, K3 {k3_cli}, "
                 f"K3-i16 {launches['K3-i16']}")
        variants = {tag: v for tag, (_, v) in cuda_runs.items()}
        variants["256x256 i16"] = i16_variant
        if variants != {"256x256": "cuda-resident", "1024x1024": "cuda-inplace",
                        "256x256 i16": "cuda-inplace-i16"}:
            fail(f"unexpected kernels for the CLI runs: {variants}")
        f32_256 = cuda_runs["256x256"][0]
        i16_256 = cli_check(os.path.join(f32_256, "av_vels.dat"),
                            os.path.join(f32_256, "final_state.dat"), i16_dir,
                            "256x256 i16 vs f32")
        torch_dirs = {tag: cli_run(tag, pf, of, "torch")[0] for tag, pf, of in runs}
        checks = []
        for tag, *_ in runs:
            a, b = cuda_runs[tag][0], torch_dirs[tag]
            cli_check(os.path.join(b, "av_vels.dat"), os.path.join(b, "final_state.dat"), a,
                      f"{tag} cuda vs torch")
            # Fields are bitwise equal, so the final states are byte-identical;
            # av_vels differ only by the order of the |u| sums.
            if not same_final_state(a, b):
                fail(f"{tag}: cuda and torch final_state.dat differ")
            checks.append(f"{tag} ({variants[tag]}) passed, final_state.dat byte-identical")
        print(f"[5 CLI end to end] card: {card} | 256x256 x 4400 steps, 1024x1024 x 2000 steps "
              f"| check cuda vs torch: {'; '.join(checks)} | 256x256 --storage i16 "
              f"(cuda-inplace-i16) vs f32, max deviation av_vels, final_state: "
              f"{', '.join(i16_256)} | launches K2 {launches['K2']}, K3 {k3_cli}, "
              f"K3-i16 {launches['K3-i16']}{elapsed()}")

        # Phase 5b: the 1024x1024 reference scene at full length against golden/.
        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
        ref_fs = os.path.join(golden, "1024x1024.final_state.dat.gz")
        ref_av = os.path.join(golden, "1024x1024.av_vels.dat.gz")
        cells = np.loadtxt(ref_fs, usecols=[0, 1, 6], dtype=np.int64)
        walls = cells[cells[:, 2] != 0]
        gparams = LBMParams(nx=1024, ny=1024, max_iters=20000, reynolds_dim=10,
                            density=0.1, accel=0.01, omega=1.85)
        gp, go = os.path.join(td, "input_1024x1024_golden.params"), \
            os.path.join(td, "obstacles_1024x1024_golden.dat")
        with open(gp, "w") as fp:
            fp.write("1024\n1024\n20000\n10\n0.1\n0.01\n1.85\n")
        with open(go, "w") as fp:
            fp.writelines(f"{x} {y} 1\n" for x, y, _ in walls)
        golden_dev, golden_dirs = {}, {}
        inplace_cuda.LAUNCHES = 0
        k3i_before = inplace_cuda.LAUNCHES_I16
        temporal_cuda.LAUNCHES_I16 = 0
        for storage, extra, want in (("f32", (), "cuda-inplace"), ("i16", (), "cuda-inplace-i16"),
                                     ("i16", ("--temporal-k", "4"), "cuda-trapezoid-i16")):
            out_dir, got = cli_run("golden1024", gp, go, "cuda", "--storage", storage, *extra)
            if got != want:
                fail(f"golden run --storage {storage} {' '.join(extra)}: variant {got}, "
                     f"expected {want}")
            golden_dev[want] = cli_check(ref_av, ref_fs, out_dir, f"golden {want}")
            golden_dirs[want] = out_dir
            plan_cases.append((gp, go, "cuda", ("--storage", storage, *extra), {}, got,
                               {"cuda-inplace": "K3", "cuda-inplace-i16": "K3-i16",
                                "cuda-trapezoid-i16": "K4-i16"}[want]))
        launches["K3"] = inplace_cuda.LAUNCHES
        golden_k3i = inplace_cuda.LAUNCHES_I16 - k3i_before
        golden_k4i = temporal_cuda.LAUNCHES_I16
        launches["K3-i16"] += golden_k3i
        if min(launches["K3"], golden_k3i, golden_k4i) <= 0:
            fail(f"golden runs skipped a kernel: K3 {launches['K3']}, K3-i16 {golden_k3i}, "
                 f"K4-i16 {golden_k4i}")
        print(f"[5b golden 1024x1024] card: {card} | scene from golden/ ({len(walls)} wall "
              f"cells, {gparams.max_iters} steps, accel {gparams.accel}) | check vs golden "
              f"(max deviation av_vels, final_state): "
              + "; ".join(f"{v} {', '.join(d)}" for v, d in golden_dev.items())
              + f" | launches K3 {launches['K3']}, K3-i16 {golden_k3i}, K4-i16 {golden_k4i}"
              + elapsed())

        # Phase 5l: K10 at full length on the golden scene (its main path:
        # its count starts from 0 here), and the other forced kinds.
        blocked_cuda.LAUNCHES = 0
        with dryrun.env(LBM_RESIDENT_KIND="blocked"):
            blocked_dir, got = cli_run("golden1024-blocked", gp, go, "cuda")
        launches["K10"] = blocked_cuda.LAUNCHES
        if got != "cuda-blocked" or launches["K10"] <= 0:
            fail(f"LBM_RESIDENT_KIND=blocked golden run: variant {got}, K10 launches "
                 f"{launches['K10']}")
        if not same_final_state(blocked_dir, golden_dirs["cuda-inplace"]):
            fail("golden cuda-blocked: final_state.dat differs from cuda-inplace's")
        plan_cases.append((gp, go, "cuda", (), {"LBM_RESIDENT_KIND": "blocked"}, got, "K10"))
        av_k10, av_k3 = (read_av_vels(os.path.join(d, "av_vels.dat"))
                         for d in (blocked_dir, golden_dirs["cuda-inplace"]))
        k10_av_rel = float(np.max(np.abs(av_k10 - av_k3) / np.abs(av_k3)))
        if av_k10.shape != (gparams.max_iters,) or k10_av_rel > 1e-6:
            fail(f"golden cuda-blocked: av_vels {av_k10.shape} off cuda-inplace's by "
                 f"{k10_av_rel:.3e} relative")
        blocked_dev = cli_check(ref_av, ref_fs, blocked_dir, "golden cuda-blocked")
        forced = []
        for forced_kind, want, (tag, pf, of), ref_dir in (
                ("mono", "cuda-resident", runs[0], cuda_runs["256x256"][0]),
                ("inplace", "cuda-inplace", runs[0], cuda_runs["256x256"][0])):
            with dryrun.env(LBM_RESIDENT_KIND=forced_kind):
                before = resident_cuda.LAUNCHES, inplace_cuda.LAUNCHES
                d, got = cli_run(f"{tag}-{forced_kind}", pf, of, "cuda")
                moved = [k for k, b, a in zip(("K2", "K3"), before, (
                    resident_cuda.LAUNCHES, inplace_cuda.LAUNCHES)) if a > b]
            plan_cases.append((pf, of, "cuda", (), {"LBM_RESIDENT_KIND": forced_kind}, got,
                               moved[0] if len(moved) == 1 else f"counters moved: {moved}"))
            if got != want or not same_final_state(d, ref_dir):
                fail(f"LBM_RESIDENT_KIND={forced_kind} at {tag}: variant {got}, or "
                     "final_state.dat differs from the default run's")
            forced.append(f"{forced_kind} at {tag}: {got}, byte-identical to the default run")
        buf = io.StringIO()
        with dryrun.env(LBM_RESIDENT_KIND="mono"), contextlib.redirect_stderr(buf):
            rc = cli.main(["run", gp, go, "--variant", "cuda", "--no-output"])
        if rc != 1 or "LBM_RESIDENT_KIND=mono" not in buf.getvalue():
            fail(f"LBM_RESIDENT_KIND=mono at 1024x1024 exited {rc}: {buf.getvalue()}")
        forced.append("mono at 1024x1024: exit 1 (" + buf.getvalue().strip() + ")")
        print(f"[5l K10 on the golden scene] card: {card} | LBM_RESIDENT_KIND=blocked, "
              f"{gparams.max_iters} steps: cuda-blocked, final_state.dat "
              f"byte-identical to cuda-inplace, av_vels max rel {k10_av_rel:.2e} from it, "
              f"vs golden (av_vels, final_state) "
              f"{', '.join(blocked_dev)}, {mlups['golden1024-blocked cuda-blocked']:.1f} MLUPS "
              f"| {'; '.join(forced)} | launches K10 {launches['K10']}{elapsed()}")

        # Phase 5c: large grids, f32 cuda against torch and i16 against f32.
        big = [(f"{n}x{n}", *scene_files(n, 2000, "channel", 0.01)) for n in (1536, 2048)]
        fused_cuda.LAUNCHES = 0
        fused_cuda.LAUNCHES_I16 = 0
        f32_dev, i16_dev = [], []
        torch_big, k1_dirs = {}, {}
        for tag, pf, of in big:
            ref_dir, ref_variant = cli_run(tag, pf, of, "cuda", "--storage", "f32",
                                           "--temporal-k", "1")
            k1_dirs[tag] = ref_dir
            out_dir, got = cli_run(tag, pf, of, "cuda", "--storage", "i16")  # the default
            if (ref_variant, got) != ("cuda-step", "cuda-step-i16"):
                fail(f"{tag}: variants {ref_variant}, {got}; expected cuda-step(-i16)")
            torch_dir, _ = cli_run(tag, pf, of, "torch")
            torch_big[tag] = torch_dir
            dev_pct = cli_check(os.path.join(torch_dir, "av_vels.dat"),
                                os.path.join(torch_dir, "final_state.dat"), ref_dir,
                                f"{tag} cuda vs torch")
            if not same_final_state(ref_dir, torch_dir):
                fail(f"{tag}: cuda and torch final_state.dat differ")
            f32_dev.append(f"{tag} {', '.join(dev_pct)}")
            dev_pct = cli_check(os.path.join(ref_dir, "av_vels.dat"),
                                os.path.join(ref_dir, "final_state.dat"), out_dir,
                                f"{tag} i16 vs f32")
            i16_dev.append(f"{tag} {', '.join(dev_pct)}")
        launches["K1"], launches["K1-i16"] = fused_cuda.LAUNCHES, fused_cuda.LAUNCHES_I16
        if launches["K1"] <= 0 or launches["K1-i16"] <= 0:
            fail(f"main path skipped a kernel: K1 {launches['K1']}, K1-i16 {launches['K1-i16']}")
        print(f"[5c CLI large grids] card: {card} | channel x 2000 steps (max deviation "
              f"av_vels, final_state) | f32 --temporal-k 1 (cuda-step) vs torch, "
              f"final_state.dat byte-identical: {'; '.join(f32_dev)} | --storage i16 "
              f"(default: cuda-step-i16) vs f32: "
              f"{'; '.join(i16_dev)} | launches K1 {launches['K1']}, "
              f"K1-i16 {launches['K1-i16']}{elapsed()}")

        # Phase 5d: the temporal path through the CLI, under the default
        # policy and with a forced depth under each LBM_TEMPORAL_IMPL.
        for mod in (temporal_cuda, skew_cuda):
            mod.LAUNCHES = 0
            mod.LAUNCHES_I16 = 0
        policies = (("default", None, ()), ("trapezoid", "trapezoid", ("--temporal-k", "4")),
                    ("skew", "skew", ("--temporal-k", "4")))
        scenes = {tag: (pf, of) for tag, pf, of in big}
        scenes["4096x4096"] = scene_files(4096, 400, "channel", 0.01)
        notes = []
        for tag, (pf, of) in scenes.items():
            dirs, fields = {}, {}
            # At 4096x4096 the forced runs go through run_simulation and are
            # compared as fields: each final_state.dat there is 1.5 GB of text.
            in_memory = tag == "4096x4096"
            for storage in ("f32", "i16"):
                sfx = "-i16" if storage == "i16" else ""
                for label, impl, extra in policies:
                    if tag == "1536x1536" and (storage, label) != ("f32", "default"):
                        continue
                    if (in_memory and storage == "f32" and impl is not None
                            and f"cuda-{impl}" == DEFAULT_VARIANTS[(tag, "f32")]):
                        continue  # the default there: the same variant and depth
                    with temporal_impl(impl):
                        if in_memory and impl is not None:
                            res = run_simulation(load_scene(pf, of), RunConfig(
                                variant="cuda", device="cuda", storage=storage, temporal_k=4))
                            fields[(storage, label)], got = res.f, res.variant
                        else:
                            dirs[(storage, label)], got = cli_run(
                                f"{tag}-{label}", pf, of, "cuda", "--storage", storage, *extra)
                    want = (DEFAULT_VARIANTS[(tag, storage)] if impl is None
                            else f"cuda-{impl}{sfx}")
                    if got != want:
                        fail(f"{tag} {storage} {label}: variant {got}, expected {want}")
            ref = torch_big.get(tag, dirs[("f32", "default")])
            for (storage, label), d in dirs.items():
                if storage == "f32" and d != ref and not same_final_state(d, ref):
                    fail(f"{tag} f32 {label}: final_state.dat differs from {ref}")
            note = [f"{tag}: default " + ", ".join(
                DEFAULT_VARIANTS[(tag, s)] for s in ("f32", "i16") if (tag, s) in DEFAULT_VARIANTS)]
            if tag == "2048x2048":
                dev_pct = cli_check(os.path.join(ref, "av_vels.dat"),
                                    os.path.join(ref, "final_state.dat"),
                                    dirs[("f32", "default")], f"{tag} temporal f32 vs torch")
                note.append(f"f32 default vs torch {', '.join(dev_pct)}")
            if tag in torch_big:
                note.append("f32 final_state.dat byte-identical to --variant torch")
            if in_memory:
                f32_default = run_simulation(load_scene(pf, of),
                                             RunConfig(variant="cuda", device="cuda")).f
                forced = [label for st, label in fields if st == "f32"]
                for label in forced:
                    if not np.array_equal(fields[("f32", label)], f32_default):
                        fail(f"{tag}: forced f32 {label} fields differ from the default run's")
                if not np.array_equal(fields[("i16", "trapezoid")], fields[("i16", "skew")]):
                    fail(f"{tag}: K4-i16 and K5-i16 fields differ")
                note.append(f"forced runs through run_simulation: f32 {', '.join(forced)} fields "
                            f"equal to the default's, K4-i16 and K5-i16 fields equal")
                del f32_default, fields
            elif ("i16", "skew") in dirs:
                if not same_final_state(dirs[("i16", "trapezoid")], dirs[("i16", "skew")]):
                    fail(f"{tag}: K4-i16 and K5-i16 final_state.dat differ")
                note.append("K4-i16 and K5-i16 final_state.dat byte-identical")
            f32_ref = dirs[("f32", "default")]
            for (storage, label), d in dirs.items():
                if storage == "i16" and label != "skew":  # skew: trapezoid's bytes
                    tol = 1.0 if label == "default" else I16_SWEEP_TOLERANCE
                    dev_pct = cli_check(os.path.join(f32_ref, "av_vels.dat"),
                                        os.path.join(f32_ref, "final_state.dat"), d,
                                        f"{tag} i16 {label} vs f32", tol)
                    note.append(f"i16 {label} vs f32 ({tol}%) {', '.join(dev_pct)}")
            notes.append("; ".join(note))
            if tag == "4096x4096":  # 1.5 GB per final_state.dat
                for d in dirs.values():
                    shutil.rmtree(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--grid", "2048x2048", "--steps", "2000", "--repeats", "1"])
        report = json.loads(buf.getvalue().splitlines()[-1])
        if rc != 0 or report["variant"] != DEFAULT_VARIANTS[("2048x2048", "f32")]:
            fail(f"bench --grid 2048x2048 exited {rc}: {report}")
        notes.append(f"bench --grid 2048x2048: {report['variant']} {report['value']} MLUPS")
        for key, mod in (("K4", temporal_cuda), ("K5", skew_cuda)):
            launches[key], launches[key + "-i16"] = mod.LAUNCHES, mod.LAUNCHES_I16
        if min(launches[k] for k in ("K4", "K4-i16", "K5", "K5-i16")) <= 0:
            fail(f"temporal CLI runs skipped a kernel: {launches}")
        print(f"[5d CLI temporal path] card: {card} | channel, 2000 steps (4096x4096: 400); "
              f"default policy, --temporal-k 4 with LBM_TEMPORAL_IMPL=trapezoid and =skew "
              f"(max deviation av_vels, final_state) | {' | '.join(notes)} | launches "
              + ", ".join(f"{k} {launches[k]}" for k in ("K4", "K4-i16", "K5", "K5-i16"))
              + elapsed())

        # Phase 5k: the HBM-parts sweep through the CLI, forced (as in
        # lbm_tpu), at 2048x2048 against 5c's K1 run.  Its count starts from
        # 0 here: this run is K9's main path.
        hbm_rows, hbm_slots = hbm_cuda.plan(bench.make_scene("2048x2048").params, 4)
        hbm_cuda.LAUNCHES = 0
        with temporal_impl("hbm"):
            hbm_dir, got = cli_run("2048x2048-hbm", *scenes["2048x2048"], "cuda")
        launches["K9"] = hbm_cuda.LAUNCHES
        # One launch a sweep: the run's 500 and the warm-up's one
        # (driver._Advance.warm: a sweep and a step).
        if got != "cuda-hbm" or launches["K9"] != 2000 // 4 + 1:
            fail(f"LBM_TEMPORAL_IMPL=hbm at 2048x2048: variant {got}, K9 launches "
                 f"{launches['K9']} for {2000 // 4} sweeps and the warm-up's one")
        plan_cases.append((*scenes["2048x2048"], "cuda", (), {"LBM_TEMPORAL_IMPL": "hbm"}, got,
                           "K9"))
        if not same_final_state(hbm_dir, k1_dirs["2048x2048"]):
            fail("LBM_TEMPORAL_IMPL=hbm at 2048x2048: final_state.dat differs from K1's")
        print(f"[5k HBM-parts sweep] card: {card} | 2048x2048 channel x 2000 steps, "
              f"LBM_TEMPORAL_IMPL=hbm: {got} (K=4, R={hbm_rows}: {2048 // hbm_rows} parts in "
              f"S={hbm_slots} slots, one launch a sweep), final_state.dat byte-identical to "
              f"--temporal-k 1 (cuda-step) | launches K9 {launches['K9']} | "
              f"{mlups['2048x2048-hbm cuda-hbm']:.1f} MLUPS{elapsed()}")

        # Phase 5e: the sharded CLI on the golden scene, 4 shards of the card.
        # The counts of the sharded kernels start from 0 here: the runs of
        # this phase are the sharded main path.
        fused_cuda.SLAB_LAUNCHES = 0
        fused_cuda.SLAB_LAUNCHES_I16 = 0
        ghosted_cuda.LAUNCHES = 0
        names = ("K1-slab", "K1-slab-i16", "K6")

        def counts():
            return fused_cuda.SLAB_LAUNCHES, fused_cuda.SLAB_LAUNCHES_I16, ghosted_cuda.LAUNCHES

        def sharded_run(tag, variant, want, uses, *extra):
            """``run --host-devices 4`` of the golden scene, which must report
            ``want`` and launch every kernel of ``uses``."""
            before = counts()
            out_dir, got = cli_run(tag, gp, go, variant, "--host-devices", "4", *extra)
            after = counts()
            if got != want:
                fail(f"{tag} --variant {variant}: variant {got}, expected {want}")
            if any(after[names.index(k)] <= before[names.index(k)] for k in uses):
                fail(f"{tag} {got} skipped a kernel of {uses}: counts {before} -> {after}")
            plan_cases.append((gp, go, variant, ("--host-devices", "4", *extra), {}, got,
                               uses[0]))
            return out_dir

        def av_rel(a, b):
            x = read_av_vels(os.path.join(a, "av_vels.dat"))
            y = read_av_vels(os.path.join(b, "av_vels.dat"))
            return float(np.max(np.abs(x - y) / np.abs(y)))

        notes = []
        sync_dir = sharded_run("golden1024", "sync", "sync", ("K1-slab",))
        single = golden_dirs["cuda-inplace"]
        if not same_final_state(sync_dir, single):
            fail("golden sync over 4 shards: final_state.dat differs from the single-device run")
        rel = av_rel(sync_dir, single)
        if rel > 1e-6:
            fail(f"golden sync over 4 shards: av_vels {rel:.3e} relative from single-device")
        notes.append(f"sync final_state.dat byte-identical to cuda-inplace, av_vels max rel "
                     f"{rel:.2e}")
        ov_dir = sharded_run("golden1024", "overlap", "overlap", ("K1-slab",))
        if not same_final_state(ov_dir, sync_dir):
            fail("golden overlap: final_state.dat differs from sync's")
        notes.append(f"overlap byte-identical to sync (av_vels max rel "
                     f"{av_rel(ov_dir, sync_dir):.2e})")
        as_dir = sharded_run("golden1024", "async", "async", ("K1-slab",))
        notes.append("async vs golden " + ", ".join(cli_check(ref_av, ref_fs, as_dir,
                                                              "golden async")))
        si_dir = sharded_run("golden1024", "sync", "sync-i16", ("K1-slab-i16",), "--storage",
                             "i16")
        if not same_final_state(si_dir, golden_dirs["cuda-inplace-i16"]):
            fail("golden sync --storage i16: final_state.dat differs from cuda-inplace-i16's")
        notes.append("sync-i16 byte-identical to cuda-inplace-i16")
        sync_dirs = {}
        for steps, variant, want, uses in ((2000, "async-k", "async-2", ("K1-slab",)),
                                           (2001, "chunked", "chunked-2+sync-tail1",
                                            ("K6", "K1-slab"))):
            tag = f"golden1024-{steps}"
            ref_dir = sharded_run(tag, "sync", "sync", ("K1-slab",), "--steps", str(steps))
            sync_dirs[steps] = ref_dir
            d = sharded_run(tag, variant, want, uses, "--steps", str(steps))
            notes.append(f"{want} x {steps} vs sync " + ", ".join(cli_check(
                os.path.join(ref_dir, "av_vels.dat"), os.path.join(ref_dir, "final_state.dat"),
                d, f"{want} vs sync")))
        for name, n in zip(names, counts()):
            launches[name] = n
        print(f"[5e sharded CLI, golden 1024x1024 over 4 shards of the card] card: {card} | "
              f"20000 steps (max deviation av_vels, final_state) | {'; '.join(notes)} | "
              f"launches " + ", ".join(f"{k} {launches[k]}" for k in names)
              + f" | {time.perf_counter() - t_start:.1f} s elapsed")

        # Phase 5h: ca on the golden scene over 4 shards of the card, at the
        # default depth, on auto and with each engine forced, f32 and int16;
        # auto on 4 shards; a step count that ends in a sync tail.  The
        # counts of the ca engines start from 0 here: these runs are their
        # main path.
        temporal_cuda.SLAB_LAUNCHES = temporal_cuda.SLAB_LAUNCHES_I16 = 0
        ca_cuda.RESIDENT_LAUNCHES = 0
        ca_cuda.INPLACE_LAUNCHES = ca_cuda.INPLACE_LAUNCHES_I16 = 0
        ca_names = ("K4-slab", "K4-slab-i16", "K7", "K8", "K8-i16")

        def ca_counts():
            return (temporal_cuda.SLAB_LAUNCHES, temporal_cuda.SLAB_LAUNCHES_I16,
                    ca_cuda.RESIDENT_LAUNCHES, ca_cuda.INPLACE_LAUNCHES,
                    ca_cuda.INPLACE_LAUNCHES_I16)

        def ca_run(tag, variant, want, use, engine, *extra):
            """``run --host-devices 4`` of the golden scene with
            LBM_CA_ENGINE=``engine`` (None: auto), which must report ``want``
            and launch ``use``."""
            before = ca_counts()
            with dryrun.env(LBM_CA_ENGINE=engine):
                out_dir, got = cli_run(tag, gp, go, variant, "--host-devices", "4", *extra)
            after = ca_counts()
            if got != want:
                fail(f"{tag} --variant {variant}: variant {got}, expected {want}")
            i = ca_names.index(use)
            if after[i] <= before[i]:
                fail(f"{tag} {got} skipped {use}: counts {before} -> {after}")
            plan_cases.append((gp, go, variant, ("--host-devices", "4", *extra),
                               {"LBM_CA_ENGINE": engine}, got, use))
            return out_dir

        notes = []
        for engine, want, use, extra in ((None, "ca-8", "K7", ()),
                                         ("slab", "ca-4", "K4-slab", ()),
                                         ("resident", "ca-4", "K7", ("--staleness", "4")),
                                         ("inplace", "ca-8", "K8", ())):
            d = ca_run(f"golden1024-ca-{engine or 'auto'}", "ca", want, use, engine, *extra)
            if not same_final_state(d, single):
                fail(f"golden {want} ({use}): final_state.dat differs from the single-device run")
            rel = av_rel(d, single)
            dev_pct = cli_check(ref_av, ref_fs, d, f"golden {want} {use}")
            notes.append(f"{want} {engine or 'auto'} ({use}) byte-identical, av_vels max rel "
                         f"{rel:.2e}, vs golden {', '.join(dev_pct)}")
        for engine, want, use, same_as in ((None, "ca-8-i16", "K8-i16", "cuda-inplace-i16"),
                                           ("slab", "ca-4-i16", "K4-slab-i16",
                                            "cuda-trapezoid-i16")):
            d = ca_run(f"golden1024-ca-i16-{engine or 'auto'}", "ca", want, use, engine,
                       "--storage", "i16")
            dev_pct = cli_check(ref_av, ref_fs, d, f"golden {want} {use}")
            if not same_final_state(d, golden_dirs[same_as]):
                fail(f"golden {want} ({use}): final_state.dat differs from {same_as}'s")
            notes.append(f"{want} {engine or 'auto'} ({use}) vs golden {', '.join(dev_pct)}, "
                         f"byte-identical to {same_as}")
        d = ca_run("golden1024-2001-auto", "auto", "ca-8+sync-tail1", "K7", None,
                   "--steps", "2001")
        if not same_final_state(d, sync_dirs[2001]):
            fail("golden auto over 4 shards x 2001 steps: final_state.dat differs from sync's")
        notes.append("auto on 4 shards x 2001 steps: ca-8+sync-tail1, byte-identical to sync")
        for name, n in zip(ca_names, ca_counts()):
            launches[name] = n
        print(f"[5h ca, golden 1024x1024 over 4 shards of the card] card: {card} | 20000 steps "
              f"(max deviation av_vels, final_state), default depth | {'; '.join(notes)} | "
              "launches " + ", ".join(f"{k} {launches[k]}" for k in ca_names)
              + f" | {time.perf_counter() - t_start:.1f} s elapsed")

        # Phase 5n: the multi-process form on the one card: 2 processes
        # (tools/pod.py, gloo: they share the card) x 2 shards each, the
        # golden scene; each rank is a fresh process whose launch counts
        # start from 0 and which prints them after its run.
        pod_rates = []
        pod_launches = {"K1-slab": 0, "K7": 0}
        card_env = {"CUDA_VISIBLE_DEVICES":
                    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}

        def pod_launch(tag, argv, env=None):
            """``argv`` on 2 ranks; (launch code, each rank's output)."""
            logs = [os.path.join(td, f"pod-{tag}-rank{r}.log") for r in range(2)]
            rc = pod.launch(2, argv, timeout=POD_TIMEOUT, logs=logs,
                            env={**card_env, **(env or {})})
            return rc, [open(x).read() for x in logs]

        def pod_run(tag, variant, want, uses, *extra):
            """``run`` of the golden scene on 2 ranks x 2 shards, which must
            report ``want`` on rank 0 alone and launch ``uses`` on both."""
            out_dir = os.path.join(td, f"pod-{tag}")
            rc, outs = pod_launch(tag, ["-c", POD_CHILD, "run", gp, go, "--variant", variant,
                                        "--device", "cuda", "--host-devices", "2",
                                        "--out-dir", out_dir, *extra])
            if rc != 0:
                fail(f"5n {tag}: the 2-process run exited {rc}:\n" + "\n".join(outs))
            got = [ln.split()[-1] for ln in outs[0].splitlines() if ln.startswith("Variant:")]
            if got != [want] or "==done==" in outs[1]:
                fail(f"5n {tag}: rank 0 reported {got} (expected {want}), rank 1 "
                     f"{'reported too' if '==done==' in outs[1] else 'nothing'}")
            counts = [json.loads(ln.split(" ", 1)[1]) for text in outs
                      for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
            if len(counts) != 2 or any(c[uses] <= 0 for c in counts):
                fail(f"5n {tag}: the ranks' {uses} counts {counts}: a rank skipped it")
            pod_launches[uses] += sum(c[uses] for c in counts)
            rate = float([ln for ln in outs[0].splitlines()
                          if ln.startswith("Compute rate:")][0].split()[-2])
            mlups[f"golden1024 2 processes x 2 shards {want}"] = rate
            pod_rates.append(f"{want} {rate:.1f} MLUPS, {1024 * 1024 / rate:.2f} us/step "
                             f"host clock")
            return out_dir

        notes_5n = []
        for variant, want, uses in (("sync", "sync", "K1-slab"), ("ca", "ca-8", "K7")):
            d = pod_run(f"golden1024-{variant}", variant, want, uses)
            if not same_final_state(d, single):
                fail(f"5n {want} on 2 processes: final_state.dat differs from the single-device "
                     "run")
            rel = av_rel(d, single)
            if rel > 1e-6:
                fail(f"5n {want} on 2 processes: av_vels {rel:.3e} relative from single-device")
            notes_5n.append(f"{want} ({uses}) x 20000 final_state.dat byte-identical to "
                            f"cuda-inplace, av_vels max rel {rel:.2e}")
        d = pod_run("golden1024-2000-async-k", "async-k", "async-2", "K1-slab", "--steps", "2000")
        notes_5n.append("async-2 x 2000 vs sync " + ", ".join(cli_check(
            os.path.join(sync_dirs[2000], "av_vels.dat"),
            os.path.join(sync_dirs[2000], "final_state.dat"), d, "5n async-2 vs sync")))
        rc, outs = pod_launch("dryrun", ["-m", "lbm_tpu_torch.tools.dryrun", "--devices", "8",
                                         "--device", "cuda"])
        rels = [ln for ln in outs[0].splitlines() if ln.startswith("dryrun ok:")]
        if rc != 0 or len(rels) != 21:
            fail(f"5n dryrun on 2 processes x 4 shards exited {rc} with {len(rels)} of 21 "
                 "relations:\n" + "\n".join(outs))
        notes_5n.append("dryrun on 2 processes x 4 shards: 21 relations hold, ulp 0")
        rc, outs = pod_launch("nccl", ["-m", "lbm_tpu_torch.tools.dist_smoke", "--device",
                                       "cuda", "--local-devices", "2"],
                              env={"LBM_DIST_BACKEND": "nccl"})
        if rc != 1 or "Error: LBM_DIST_BACKEND=nccl" not in "".join(outs):
            fail(f"5n: NCCL asked for on ranks that share the card exited {rc}, not 1 with "
                 "Error:\n" + "\n".join(outs))
        notes_5n.append("LBM_DIST_BACKEND=nccl on the shared card exits 1 with Error")
        print(f"[5n multi-process, golden 1024x1024 on 2 gloo processes x 2 shards of the card] "
              f"card: {card} | {'; '.join(notes_5n)} | {'; '.join(pod_rates)} | launches of "
              f"the ranks: " + ", ".join(f"{k} {n}" for k, n in pod_launches.items())
              + elapsed())

        # Phase 5m: frames, debug and checkpoint/resume on the card.
        from lbm_tpu_torch.models.program import u_mag_fn

        scene_g = load_scene(gp, go)
        notes = []

        def framed(num_steps=20000, resident_kind=None, **kw):
            """The golden scene through run_simulation with frames every
            100 steps, LBM_RESIDENT_KIND=``resident_kind``."""
            with dryrun.env(LBM_RESIDENT_KIND=resident_kind):
                res = run_simulation(scene_g, RunConfig(device="cuda", num_steps=num_steps,
                                                        frame_interval=100, **kw))
            n = num_steps // 100
            if res.frames.shape != (n, 1024, 1024) or not np.array_equal(
                    res.frame_steps, np.arange(n) * 100):
                fail(f"golden {res.variant} frames {res.frames.shape}")
            return res

        def same_run(res, f_ref, av_ref, av_rtol=0.0) -> float:
            """Fields equal, av_vels equal (ca: within ``av_rtol``, its frame
            segments sum |u| per sweep level from other steps than the plain
            run's sweeps); returns av_vels' largest relative difference."""
            av_rel = float(np.max(np.abs(res.av_vels - av_ref) / np.abs(av_ref)))
            av_ok = av_rel <= av_rtol if av_rtol else np.array_equal(res.av_vels, av_ref)
            if not (np.array_equal(res.f, f_ref) and av_ok):
                fail(f"golden {res.variant} with frames: fields or av_vels differ from the "
                     f"plain run (max |df| {np.abs(res.f - f_ref).max():.3e}, av max rel "
                     f"{av_rel:.3e})")
            return av_rel

        # K3 and K10: the plain K3 run here, K10's the CLI run of 5l (its
        # av_vels.dat holds float32 values exactly).
        k3_plain = run_simulation(scene_g, RunConfig(variant="cuda", device="cuda"))
        k3_frames = framed(variant="cuda")
        same_run(k3_frames, k3_plain.f, k3_plain.av_vels)
        k10_frames = framed(resident_kind="blocked", variant="cuda")
        same_run(k10_frames, k3_plain.f, av_k10.astype(np.float32))
        if (k3_plain.variant, k3_frames.variant, k10_frames.variant) != (
                "cuda-inplace", "cuda-inplace", "cuda-blocked"):
            fail(f"5m variants {k3_plain.variant}, {k3_frames.variant}, {k10_frames.variant}")
        if not np.array_equal(k3_frames.frames, k10_frames.frames):
            fail("golden frames: cuda-blocked's differ from cuda-inplace's")
        # Frames 0, 1, 100 and 199 against the twin's u_mag of a K1 run
        # stopped after k * 100 + 1 steps.
        obst_g = torch.from_numpy(scene_g.obstacles).to(dev)
        mag = u_mag_fn(obst_g)
        state = lattice.equilibrium_rest_device(gparams.density, 1024, 1024, dev)
        done = 0
        for k in (0, 1, 100, 199):
            state, _ = fused_cuda.make_run_all(gparams, obst_g, k * 100 + 1 - done)(state)
            done = k * 100 + 1
            if not np.array_equal(k3_frames.frames[k], mag(state).cpu().numpy()):
                fail(f"golden frame {k} differs from u_mag of a K1 run of {done} steps")
        notes.append("frames every 100 steps (200 x 1024x1024 on the card) on cuda-inplace and "
                     "cuda-blocked: f and av_vels equal to the plain runs (cuda-blocked: 5l's), "
                     "frames equal to each other and frames 0, 1, 100, 199 to u_mag of K1 runs "
                     "stopped at 1, 101, 10001, 19901 steps | MLUPS plain / frames: "
                     f"cuda-inplace {k3_plain.mlups:.1f} / {k3_frames.mlups:.1f}, cuda-blocked "
                     f"{mlups['golden1024-blocked cuda-blocked']:.1f} / {k10_frames.mlups:.1f}")
        mlups["golden1024 frames-100 cuda-inplace"] = k3_frames.mlups
        mlups["golden1024 frames-100 cuda-blocked"] = k10_frames.mlups
        first = k3_frames.frames[:20]
        del k3_plain, k3_frames, k10_frames
        # The sharded programs over 2000 steps: sync and ca-8 with frames
        # equal their plain runs (ca's fields sync's), and their frames the
        # single-device ones; --debug on ca-8 reads ca-8+debug-as-sync and
        # equals sync.
        sync2k = run_simulation(scene_g, RunConfig(variant="sync", device="cuda",
                                                   host_devices=4, num_steps=2000))
        ca2k = run_simulation(scene_g, RunConfig(variant="ca", device="cuda", host_devices=4,
                                                 num_steps=2000))
        if not np.array_equal(ca2k.f, sync2k.f):
            fail("golden ca-8 over 4 shards x 2000: fields differ from sync's")
        for plain, want, rtol in ((sync2k, "sync", 0.0), (ca2k, "ca-8", 1e-6)):
            res = framed(2000, variant=plain.variant.split("-")[0], host_devices=4)
            av_rel = same_run(res, plain.f, plain.av_vels, rtol)
            if res.variant != want or not np.array_equal(res.frames, first):
                fail(f"golden {res.variant} over 4 shards: frames differ from cuda-inplace's")
            notes.append(f"{want} over 4 shards x 2000 with frames: f equal to the plain run, "
                         f"av_vels max rel {av_rel:.2e}, frames equal to cuda-inplace's, MLUPS "
                         f"plain / frames {plain.mlups:.1f} / {res.mlups:.1f}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dbg = run_simulation(scene_g, RunConfig(variant="ca", device="cuda", host_devices=4,
                                                    num_steps=2000, debug=True))
        if (dbg.variant != "ca-8+debug-as-sync" or buf.getvalue().count("==timestep:") != 2000
                or not np.array_equal(dbg.f, sync2k.f)
                or not np.array_equal(dbg.av_vels, sync2k.av_vels)):
            fail(f"--debug on ca over 4 shards: {dbg.variant}, not equal to sync")
        notes.append("--debug on ca over 4 shards x 2000: ca-8+debug-as-sync, f and av_vels "
                     "equal to sync")
        del first, sync2k, ca2k, res, dbg
        # The CLI at 256x256 (phase 5's scene): animation_data every 400
        # steps, --debug for 400 steps on cuda-resident.
        tag, pf, of = runs[0]
        fr_dir, got = cli_run(f"{tag}-frames", pf, of, "cuda", "--frame-interval", "400")
        names = sorted(os.listdir(os.path.join(fr_dir, "animation_data")))
        if (got != "cuda-resident" or names != [f"velocity_magnitude_{t:06d}.dat"
                                                  for t in range(0, 4400, 400)]
                or not same_final_state(fr_dir, cuda_runs[tag][0])
                or not filecmp.cmp(os.path.join(fr_dir, "av_vels.dat"),
                                   os.path.join(cuda_runs[tag][0], "av_vels.dat"),
                                   shallow=False)):
            fail(f"{tag} --frame-interval 400: {got}, {len(names)} frame files, or its files "
                 "differ from the plain run's")
        dirs = {}
        for extra in ((), ("--debug",)):
            dirs[extra] = cli_run(f"{tag}-400", pf, of, "cuda", "--steps", "400", *extra)[0]
        if not (filecmp.cmp(os.path.join(dirs[()], "av_vels.dat"),
                            os.path.join(dirs[("--debug",)], "av_vels.dat"), shallow=False)
                and same_final_state(dirs[()], dirs[("--debug",)])):
            fail(f"{tag} --debug x 400 on cuda-resident: files differ from the plain run's")
        notes.append(f"CLI {tag}: --frame-interval 400 wrote {len(names)} frame files, "
                     "av_vels.dat and final_state.dat byte-identical to the plain run; --debug x "
                     "400 on cuda-resident: av_vels.dat and final_state.dat byte-identical")
        # --checkpoint-every 4000 on the golden scene's first 8000 steps, then
        # --resume from step 8000 to the end.
        ck_dir = os.path.join(td, "golden-ckpt")
        d_ck, _ = cli_run("golden1024-ckpt", gp, go, "cuda", "--steps", "8000",
                          "--checkpoint-every", "4000", "--checkpoint-dir", ck_dir)
        d_res, _ = cli_run("golden1024-resume", gp, go, "cuda", "--resume",
                           os.path.join(ck_dir, "ckpt_00008000.npz"))
        unbroken = golden_dirs["cuda-inplace"]
        with open(os.path.join(unbroken, "av_vels.dat")) as fp:
            prefix = fp.readlines()[:8000]
        with open(os.path.join(d_ck, "av_vels.dat")) as fp:
            ck_lines = fp.readlines()
        if ck_lines != prefix or sorted(os.listdir(ck_dir)) != ["ckpt_00004000.npz",
                                                                 "ckpt_00008000.npz"]:
            fail("golden checkpointed run: av_vels.dat is not the unbroken run's first 8000 "
                 f"lines, or checkpoints {sorted(os.listdir(ck_dir))}")
        if not (same_final_state(d_res, unbroken) and filecmp.cmp(
                os.path.join(d_res, "av_vels.dat"), os.path.join(unbroken, "av_vels.dat"),
                shallow=False)):
            fail("golden resumed run: files differ from the unbroken run's")
        notes.append(f"--steps 8000 --checkpoint-every 4000 (2 checkpoints, "
                     f"{mlups['golden1024-ckpt cuda-inplace']:.1f} MLUPS with the I/O; av_vels.dat "
                     "the unbroken run's first 8000 lines), then --resume from step 8000 "
                     f"({mlups['golden1024-resume cuda-inplace']:.1f} MLUPS): final_state.dat and "
                     "av_vels.dat byte-identical to the unbroken run")
        print(f"[5m frames, debug, checkpoint/resume] card: {card} | golden 1024x1024, "
              f"20000 steps | {' | '.join(notes)}{elapsed()}")

        # Phase (a): the verify artifact, every kernel form against the twin
        # and the golden prefixes (tools/verify_device.py), written here and
        # printed as its JSON line.
        t0 = time.perf_counter()
        report = verify_device.run_verify("cuda")
        with open(os.path.join(td, "VERIFY_H100.json"), "w") as fp:
            json.dump(report, fp, indent=1)
        print(json.dumps(report))
        probes = report["probes"]
        if (not report["ok"] or set(probes) != set(verify_device.PROBES) or len(probes) != 19
                or any(v["max_abs"] != 0.0 for v in probes.values())):
            fail(f"verify: ok {report['ok']}, probes "
                 + ", ".join(f"{k} {v['max_abs']:.3e}" for k, v in probes.items()))
        print(f"[a verify] card: {card} | {len(probes)} probes, every max |diff| 0 | golden "
              f"prefix {report['golden_prefix']['steps']} steps: "
              f"{report['golden_prefix']['variant']} {report['golden_prefix']['max_pct']:.4f}%, "
              f"{report['golden_prefix_i16']['variant']} "
              f"{report['golden_prefix_i16']['max_pct']:.4f}% | "
              f"{time.perf_counter() - t0:.1f} s{elapsed()}")

        # Phase (b): run --plan for each run of 5b, 5e, 5h, 5k and 5l, under
        # the run's forcing variables: its program is the run's Variant line
        # and its kernel the one the run's counters showed.
        def plan_of(pfile, ofile, variant, extra, env):
            buf = io.StringIO()
            with dryrun.env(**{k: env.get(k) for k in FORCING}), \
                    contextlib.redirect_stdout(buf):
                rc = cli.main(["run", pfile, ofile, "--variant", variant, "--device", "cuda",
                               *extra, "--plan"])
            text = buf.getvalue()
            words = {ln.split(":")[0]: ln.split()[1] for ln in text.splitlines()
                     if ln.startswith(("program: ", "kernel: "))}
            if rc != 0 or "will FAIL" in text:
                fail(f"plan of {variant} {' '.join(extra)} {env}: rc {rc}\n{text}")
            return words.get("program"), words.get("kernel")

        planned = []
        for pfile, ofile, variant, extra, env, got, kernel in plan_cases:
            prog, kern = plan_of(pfile, ofile, variant, extra, env)
            if (prog, kern) != (got, kernel):
                fail(f"plan of {variant} {' '.join(extra)} {env}: program {prog}, kernel {kern}; "
                     f"the run: {got} on {kernel}")
            planned.append(f"{got} {kern}")
        print(f"[b plan] card: {card} | {len(plan_cases)} runs of 5b, 5e, 5h, 5k, 5l planned "
              f"again, program = the run's Variant line, kernel = the one its counters showed: "
              + "; ".join(planned) + elapsed())

        # Phase (c): --profile on K3 (the golden scene, 2000 steps) and on
        # sync over 4 shards (200 steps): the trace holds the launched
        # kernel's events, the files equal an unprofiled run's, and the
        # device's busy share (the union of kernel intervals over the
        # compute bracket) is the first measurement of the host's share.
        notes = []
        for tag, variant, steps, extra, kname in (
                ("K3", "cuda", 2000, (), "lbm_inplace_kernel"),
                ("sync", "sync", 200, ("--host-devices", "4"), "lbm_slab_kernel")):
            flags = ("--steps", str(steps), *extra)
            plain_dir, got = cli_run(f"prof-{tag}-plain", gp, go, variant, *flags,
                                     out_dir=os.path.join(td, f"prof-{tag}-plain"))
            prof_dir, got_p = cli_run(f"prof-{tag}", gp, go, variant, *flags, "--profile",
                                      os.path.join(td, f"trace-{tag}"),
                                      out_dir=os.path.join(td, f"prof-{tag}"))
            for name in ("final_state.dat", "av_vels.dat"):
                if not filecmp.cmp(os.path.join(plain_dir, name), os.path.join(prof_dir, name),
                                   shallow=False):
                    fail(f"--profile {tag}: {name} differs from the unprofiled run's")
            with open(os.path.join(td, f"trace-{tag}", "trace.json")) as fp:
                events = json.load(fp)["traceEvents"]
            kern = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
            launched = [e for e in kern if kname in e["name"]]
            if got != got_p or not launched:
                fail(f"--profile {tag}: {got} / {got_p}, {len(kern)} kernel events, "
                     f"{len(launched)} of {kname}")
            busy = sum(e["dur"] for e in kern) * 1e-6  # one stream: no overlap
            # Kernel time per step by kernel (the name up to its template
            # or argument list), the largest first.
            per: dict[str, list] = {}
            for e in kern:
                name = e["name"].removeprefix("void ").replace("(anonymous namespace)::", "")
                entry = per.setdefault(re.split(r"[(<]", name)[0].split("::")[-1], [0, 0.0])
                entry[0] += 1
                entry[1] += e["dur"]
            split = ", ".join(f"{k} {us / steps:.2f} us ({n / steps:g} a step)" for k, (n, us) in
                              sorted(per.items(), key=lambda kv: -kv[1][1]))
            secs = {d: float([ln for ln in run_texts[d].splitlines()
                              if ln.startswith("Elapsed Compute time:")][0].split()[-2])
                    for d in (plain_dir, prof_dir)}
            notes.append(
                f"{got} x {steps}: {len(kern)} kernel events ({len(launched)} {kname}), busy "
                f"{busy * 1e3:.3f} ms = {100 * busy / secs[plain_dir]:.2f}% of the unprofiled "
                f"bracket ({secs[plain_dir] * 1e3:.3f} ms; {100 * busy / secs[prof_dir]:.2f}% of "
                f"the profiled one, {secs[prof_dir] * 1e3:.3f} ms); host per step "
                f"{(secs[plain_dir] - busy) / steps * 1e6:.2f} us beyond the kernels, kernels "
                f"{busy / steps * 1e6:.2f} us/step: {split}; files byte-identical")
        print(f"[c profile] card: {card} | " + " | ".join(notes) + elapsed())

        # Phase (d): run --divergence on the golden scene over 4 shards,
        # async-1, 2000 steps: its av_sync is 5e's sync run's av_vels.
        t0 = time.perf_counter()
        div_dir = os.path.join(td, "divergence")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", gp, go, "--divergence", "--host-devices", "4", "--staleness",
                           "1", "--steps", "2000", "--device", "cuda", "--out-dir", div_dir])
        div_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"run --divergence exited {rc}:\n{buf.getvalue()}")
        rows = np.loadtxt(os.path.join(div_dir, "divergence.csv"), delimiter=",", skiprows=1)
        av_sync = read_av_vels(os.path.join(sync_dirs[2000], "av_vels.dat"))
        if rows.shape != (2000, 6) or not np.array_equal(rows[:, 1].astype(np.float32),
                                                         av_sync.astype(np.float32)):
            fail(f"divergence {rows.shape}: av_sync differs from the sync run's av_vels.dat")
        print(f"[d divergence] card: {card} | golden 1024x1024 over 4 shards, async-1 against "
              f"sync, 2000 steps in {div_s:.1f} s: av_sync = 5e's sync av_vels.dat at the "
              f"printed digits | max av deviation {np.nanmax(rows[:, 3]):.4f}% (step "
              f"{int(rows[np.nanargmax(rows[:, 3]), 0])}), last field_rel_linf "
              f"{rows[-1, 4]:.3e}, last field_rms {rows[-1, 5]:.3e}, av deviation at the last "
              f"step {rows[-1, 3]:.4f}%{elapsed()}")

        # Phase (e): golden --variant cuda on phase 5's 256x256 scene writes
        # that run's two files.
        tag, pf, of = runs[0]
        gold_dir = os.path.join(td, "golden-cmd")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["golden", pf, of, "--variant", "cuda", "--out-dir", gold_dir])
        for mine, theirs in (("256x256.av_vels.dat", "av_vels.dat"),
                             ("256x256.final_state.dat", "final_state.dat")):
            if rc != 0 or not filecmp.cmp(os.path.join(gold_dir, mine), os.path.join(
                    cuda_runs[tag][0], theirs), shallow=False):
                fail(f"golden --variant cuda {tag} (rc {rc}): {mine} differs from the run's "
                     f"{theirs}\n{buf.getvalue()}")
        print(f"[e golden] card: {card} | golden --variant cuda on the {tag} cylinder x 4400 "
              f"steps ({buf.getvalue().strip().split('variant=')[-1].rstrip(')')}): both files "
              f"byte-identical to phase 5's run{elapsed()}")

    # Phase 5f: large shards, 4096x4096 over 4 shards of 1024x4096.
    p4k = LBMParams(nx=4096, ny=4096, max_iters=200, reynolds_dim=10, density=0.1, accel=0.01,
                    omega=1.85)
    scene4k = Scene(p4k, scenegen.make_mask("channel", 4096, 4096))
    r_k1 = run_simulation(scene4k, RunConfig(variant="cuda", device="cuda", temporal_k=1))
    slab_5f = fused_cuda.SLAB_LAUNCHES
    r_sync = run_simulation(scene4k, RunConfig(variant="sync", device="cuda", host_devices=4))
    if r_k1.variant != "cuda-step" or not np.array_equal(r_sync.f, r_k1.f):
        fail(f"4096x4096 sync over 4 shards differs from single-device {r_k1.variant}")
    sync_rel = float(np.max(np.abs(r_sync.av_vels - r_k1.av_vels) / np.abs(r_k1.av_vels)))
    if sync_rel > 1e-6:
        fail(f"4096x4096 sync av {sync_rel:.3e} relative from K1")
    k6_before = ghosted_cuda.LAUNCHES
    slab_before = fused_cuda.SLAB_LAUNCHES
    r_ch = run_simulation(scene4k, RunConfig(variant="chunked", device="cuda", host_devices=4))
    ch_rel = float(np.max(np.abs(r_ch.av_vels - r_sync.av_vels) / np.abs(r_sync.av_vels)))
    if (r_ch.variant != "chunked-2" or ghosted_cuda.LAUNCHES != k6_before
            or fused_cuda.SLAB_LAUNCHES <= slab_before or ch_rel > 0.01):
        fail(f"4096x4096 chunked: {r_ch.variant}, K6 {k6_before} -> {ghosted_cuda.LAUNCHES}, "
             f"av {ch_rel:.3e} from sync")
    slab_5f = fused_cuda.SLAB_LAUNCHES - slab_5f
    print(f"[5f large shards 4096x4096 over 4 shards of 1024x4096] card: {card} | channel, 200 "
          f"steps | sync fields equal to cuda-step (K1), av max rel {sync_rel:.2e} | chunked-2 "
          f"on the K1-slab loop (K6 not launched), av max rel {ch_rel:.2e} from sync | MLUPS "
          f"cuda-step {r_k1.mlups:.1f}, sync {r_sync.mlups:.1f}, chunked-2 {r_ch.mlups:.1f} | "
          f"launches K1-slab {slab_5f}")
    del r_k1, r_sync, r_ch

    # Phase 5g: the dryrun analog on 8 shards of the card.
    lines = dryrun.dryrun(8, "cuda")
    print(f"[5g dryrun, 8 shards of the card] card: {card} | {len(lines)} relations hold, ulp 0 "
          f"| {time.perf_counter() - t_start:.1f} s elapsed")

    # Phase 6: rates.
    print(f"[6a run MLUPS] card: {card} | "
          + "; ".join(f"{k} {v:.1f}" for k, v in mlups.items()))
    gbps = kernel_times.copy_gbps(dev, repeats=5)
    l2 = kernel_times.l2_rates(dev, repeats=5)
    table = {n: kernel_times.time_grid(n, dev, repeats=5) for n in GRID_SIZES + (1536,)}
    print(f"[6b us/step: median [q1, q3], MLUPS, GB/s] card: {card} | "
          f"copy 1 GiB {gbps[0]:.1f} GB/s | {kernel_times.format_l2(l2)} | "
          + " ; ".join(kernel_times.format_grid(n, t) for n, t in table.items()))

    sweeps = {n: kernel_times.time_sweeps(n, dev, SWEEP_DEPTHS, repeats=5) for n in SWEEP_GRIDS}
    print(f"[6c sweeps in turns with K1: us/step median [q1, q3], MLUPS, one-step GB/s] "
          f"card: {card} | " + " ; ".join(kernel_times.format_grid(n, t)
                                           for n, t in sweeps.items()))

    # Phase 6d: the sharded disciplines' rates and their kernels' times.
    shard_times = {n: kernel_times.time_shard(n, dev, repeats=5) for n in (1024, 4096)}
    scene_b = bench.make_scene("4096x4096")
    rates4k, fields4k = {}, {}
    slab_6d = temporal_cuda.SLAB_LAUNCHES
    for variant in ("cuda", "sync", "overlap", "async", "async-k", "chunked", "ca"):
        res = run_simulation(scene_b, RunConfig(variant=variant, device="cuda", num_steps=400,
                                                host_devices=None if variant == "cuda" else 4))
        rates4k[res.variant] = res.mlups
        if variant in ("sync", "ca"):
            fields4k[res.variant] = res.f
    slab_6d = temporal_cuda.SLAB_LAUNCHES - slab_6d
    if set(fields4k) != {"sync", "ca-4"} or not np.array_equal(fields4k["ca-4"],
                                                               fields4k["sync"]):
        fail(f"4096x4096 over 4 shards x 400 steps: ca ({sorted(fields4k)}) differs from sync")
    if slab_6d <= 0:
        fail("4096x4096 ca over 4 shards did not launch K4-slab")
    # The card-bound int16 sharded run: sync-i16 on K1-slab-i16, against the
    # single-device int16 default (cuda-step-i16, K1-i16).
    fields4k = {}
    slab_i16_6d = fused_cuda.SLAB_LAUNCHES_I16
    for variant in ("cuda", "sync"):
        res = run_simulation(scene_b, RunConfig(variant=variant, device="cuda", num_steps=400,
                                                storage="i16",
                                                host_devices=None if variant == "cuda" else 4))
        rates4k[res.variant] = res.mlups
        fields4k[res.variant] = res.f
    slab_i16_6d = fused_cuda.SLAB_LAUNCHES_I16 - slab_i16_6d
    if set(fields4k) != {"cuda-step-i16", "sync-i16"} or not np.array_equal(
            fields4k["sync-i16"], fields4k["cuda-step-i16"]):
        fail(f"4096x4096 int16 over 4 shards x 400 steps: sync-i16 ({sorted(fields4k)}) differs "
             "from cuda-step-i16")
    if slab_i16_6d <= 0:
        fail("4096x4096 sync-i16 over 4 shards did not launch K1-slab-i16")
    del fields4k
    golden_rates = {k: v for k, v in mlups.items() if k.startswith("golden1024")}
    print(f"[6d sharded rates] card: {card} | MLUPS, golden 1024x1024 (4 shards unless "
          f"cuda-*; 20000 steps, async-2 2000, chunked 2001): "
          + "; ".join(f"{k} {v:.1f}" for k, v in golden_rates.items())
          + " | 4096x4096 box x 400 steps (ca-4 on K4-slab, fields equal to sync; sync-i16 "
            f"fields equal to cuda-step-i16; K4-slab launches {slab_6d}, K1-slab-i16 "
            f"{slab_i16_6d}): " + "; ".join(f"{k} {v:.1f}" for k, v in rates4k.items())
          + " | shard kernels in turns (K1-slab and K6: host-paced, and card-paced from a "
            "CUDA graph), then plain: "
          + " ; ".join(kernel_times.format_shard(n, t) for n, t in shard_times.items()))

    # Phase 6e: the ca engines in turns on the shards of the 1024^2 and
    # 4096^2 runs over 4, and K9 against K5, K4 and K1 in turns at 2048^2.
    ca_times = {(256, 1024): kernel_times.time_ca(256, 1024, dev, (4, 8), (1,), repeats=5),
                (1024, 4096): kernel_times.time_ca(1024, 4096, dev, (4,), (4, 8), repeats=5)}
    hbm_times = kernel_times.time_hbm(2048, dev, (4,), repeats=5)
    print(f"[6e ca engines and K9 in turns with K5, K4, K1] card: {card} | "
          + " ; ".join(kernel_times.format_ca(n, nx, t) for (n, nx), t in ca_times.items())
          + " ; " + kernel_times.format_grid(2048, hbm_times))

    # Phase 6f: K10 in turns with K3 and K4 (K = 4) at 1024^2, the grid of
    # its main path (5l).
    blocked_times = kernel_times.time_blocked(1024, dev, repeats=5,
                                              block_rows=(blocked_cuda.DEFAULT_BLOCK_ROWS,))
    print(f"[6f K10 in turns] card: {card} | in turns "
          + kernel_times.format_grid(1024, blocked_times) + elapsed())

    # Phase 7: kernel findings, then the last line.  A launch of K1 is one
    # step; one of K2 or K3 is 256 steps; one of K4 or K5 is K steps; one of
    # K1-slab one step of one shard; one of K6 k steps of one shard.  Every
    # row has its bound (bound_ms: the launch's bytes over 3.35 TB/s or its
    # operations over 67 TFLOP/s, whichever is larger) and the memory tier
    # its state lives in, with tier_bound_ms, the bytes it moves over that
    # tier's measured rate: for a state in HBM the 1 GiB copy's of phase 6b
    # (a one-step kernel's state read and written once per launch); for a
    # state in L2 (K2, K3, K6, K7, K8) the L2 copy's of 6b with a barrier
    # per pass, at the smallest measured working set that holds the
    # kernel's copies (9.6, 18 or 36 MiB), over every step of the launch
    # (9 values read and written per cell-step).  No single PyTorch call
    # computes a D2Q9 step, so library_ms is null.
    chunk = inplace_cuda.DEFAULT_CHUNK

    def l2_tier_ms(cells, steps, storage, copies):
        """The launch's state traffic over the L2 copy's rate at the working
        set of ``copies`` copies of a ``cells``-cell state: (ms, working
        set label)."""
        vb = 2 if storage == "i16" else 4
        label, rate = kernel_times.l2_rate_for(l2, copies * 9 * cells * vb)
        return cells * steps * 2 * 9 * vb / (rate * 1e9) * 1e3, label

    def bounds(rows, nx, fluid, steps, storage, tier, ghosts=False, copies=1):
        """bound_ms, bound_by, tier and tier_bound_ms of one launch on a
        rows x nx state (a shard: plus its two ghost rows), ``copies``
        copies of it in L2."""
        cells = rows * nx
        extra = 2 * 9 * nx * (2 if storage == "i16" else 4) if ghosts else 0
        b, by = kernel_times.bound_ms(cells, fluid, steps, storage, extra)
        per_cell = (kernel_times.BYTES_PER_CELL_STEP_I16 if storage == "i16"
                    else kernel_times.BYTES_PER_CELL_STEP)
        if tier == "HBM":
            tier_b, tier = cells * per_cell / (gbps[0] * 1e9) * 1e3, "HBM"
        else:
            tier_b, label = l2_tier_ms(cells, steps, storage, copies)
            tier = f"L2 ({label} copy)"
        return {"bound_ms": b, "bound_by": by, "library_ms": None, "tier": tier,
                "tier_bound_ms": tier_b}

    def row(name, source, replaces, key, err, n, plain, per_launch, storage, tier, copies=1):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err,
                "ms": table[n][key][0] / 1e3 * per_launch,
                "plain_ms": table[n][plain][0] / 1e3 * per_launch,
                **bounds(n, n, (n - 2) ** 2, per_launch, storage, tier, copies=copies)}

    kernels = [
        row("K1 one-step fused kernel (ms per launch = 1 step, 1536x1536)",
            "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/fused_pallas.py:249",
            "K1", k1_err, 1536, "twin", 1, "f32", "HBM"),
        row("K2 persistent multi-step kernel (ms per launch = 256 steps, 256x256)",
            "lbm_tpu_torch/csrc/resident.cu", "lbm_tpu/ops/resident_pallas.py:213",
            "K2", k2_err, 256, "twin", resident_cuda.DEFAULT_CHUNK, "f32", "L2", copies=2),
        row("K3 in-place persistent kernel (ms per launch = 256 steps, 1024x1024)",
            "lbm_tpu_torch/csrc/inplace.cu", "lbm_tpu/ops/resident_pallas.py:601",
            "K3", k3_err, 1024, "twin", chunk, "f32", "L2"),
        row("K3-i16 in-place persistent kernel, int16 state (ms per launch = 256 steps, "
            "1024x1024)", "lbm_tpu_torch/csrc/inplace.cu",
            "lbm_tpu/ops/resident_pallas.py:601", "K3-i16", k3i_err, 1024, "twin-i16", chunk,
            "i16", "L2"),
        row("K1-i16 one-step fused kernel, int16 state (ms per launch = 1 step, 1536x1536)",
            "lbm_tpu_torch/csrc/step.cu", "lbm_tpu/ops/fused_pallas.py:249",
            "K1-i16", k1i_err, 1536, "twin-i16", 1, "i16", "HBM"),
    ]
    # One row per sweep kernel: the launches of phase 5d, which run K=4, its
    # largest difference from plain over every case of phase 3d, and its
    # time at 2048x2048, K=4 (the bench grid).  Its other timed
    # configurations sit in "by_grid_and_depth", each with its own case's
    # difference from phase 3d.
    sweep_rows = (("K4", "trapezoid sweep kernel", "temporal.cu", "temporal_pallas.py:169"),
                  ("K5", "skewed sweep kernel", "skew.cu", "skew_pallas.py:211"))

    def per_launch_ms(n, name, K):
        return sweeps[n][f"{name} K={K}"][0] / 1e3 * K

    for key, what, source, replaces in sweep_rows:
        for sfx, state in (("", ""), ("-i16", ", int16 state")):
            kern, plain = key + sfx, "plain" + sfx
            storage = "i16" if sfx else "f32"
            kernels.append({
                "name": f"{kern} {what}{state} (ms per launch = 4 steps, 2048x2048, K=4)",
                "route": "cuda", "source": f"lbm_tpu_torch/csrc/{source}",
                "replaces": f"lbm_tpu/ops/{replaces}", "launches": launches[kern],
                "max_abs_err": max(e for k, e in sweep_err.items() if k[0] == kern),
                "ms": per_launch_ms(2048, kern, 4), "plain_ms": per_launch_ms(2048, plain, 4),
                **bounds(2048, 2048, 2046 ** 2, 4, storage, "HBM"),
                "by_grid_and_depth": [
                    {"grid": f"{n}x{n}", "K": K, "ms": per_launch_ms(n, kern, K),
                     "plain_ms": per_launch_ms(n, plain, K),
                     "max_abs_err": sweep_err[(kern, n, n, K)],
                     **bounds(n, n, (n - 2) ** 2, K, storage, "HBM")}
                    for n in SWEEP_GRIDS for K in SWEEP_DEPTHS]})

    # The sharded kernels, timed on the last shard of the n x n box over 4
    # (rows 3n/4 .. n-1: its top row and edge columns are walls).  K1-slab's
    # time is card-paced (its loop replayed from a CUDA graph), with the
    # host-paced loop's, the sharded runs' own pace, beside it.
    def shard_row(n, timed, plain, per_launch, storage, tier):
        rows = n // 4
        paced = ({"ms": shard_times[n][f"{timed} graph"][0] / 1e3 * per_launch,
                  "host_paced_ms": shard_times[n][timed][0] / 1e3 * per_launch}
                 if f"{timed} graph" in shard_times[n] else
                 {"ms": shard_times[n][timed][0] / 1e3 * per_launch})
        return {**paced, "plain_ms": shard_times[n][plain][0] / 1e3 * per_launch,
                **bounds(rows, n, (rows - 1) * (n - 2), per_launch, storage, tier, ghosts=True,
                         copies=2)}

    for key, storage, what in (("K1-slab", "f32", ""), ("K1-slab-i16", "i16", ", int16 state")):
        sfx = "-i16" if storage == "i16" else ""
        kernels.append({
            "name": f"{key} one-step slab kernel of the sharded modes{what} (ms per launch = "
                    "1 step of one 256x1024 shard of 1024x1024, card-paced; the shard's copies "
                    "sit in L2)",
            "route": "cuda", "source": "lbm_tpu_torch/csrc/step.cu",
            "replaces": "lbm_tpu/ops/fused_pallas.py:581", "launches": launches[key],
            # and the two ranks' of 5n (the multi-process runs)
            "launches_5n": pod_launches.get(key, 0), "max_abs_err": slab_err[key],
            **shard_row(1024, key, f"plain-slab{sfx}", 1, storage, "L2"),
            "by_shard": [{"shard": "1024x4096 of 4096x4096",
                          "launches_5f": slab_5f if storage == "f32" else 0,
                          "launches_6d": slab_i16_6d if storage == "i16" else 0,
                          **shard_row(4096, key, f"plain-slab{sfx}", 1, storage, "HBM")}]})
    kernels.append({
        "name": "K6 ghosted chunk kernel (ms per launch = 2 steps of one 256x1024 shard of "
                "1024x1024, k = 2, card-paced)",
        "route": "cuda", "source": "lbm_tpu_torch/csrc/ghosted.cu",
        "replaces": "lbm_tpu/ops/resident_pallas.py:997", "launches": launches["K6"],
        "max_abs_err": slab_err["K6"],
        **shard_row(1024, "K6 k=2", "plain K6 k=2", 2, "f32", "L2"),
        "by_chunk": [{"k": 8, "ms": shard_times[1024]["K6 k=8 graph"][0] / 1e3 * 8,
                      "host_paced_ms": shard_times[1024]["K6 k=8"][0] / 1e3 * 8,
                      **bounds(256, 1024, 255 * 1022, 8, "f32", "L2", ghosts=True,
                               copies=2)}]})
    # The ca engines (ms per launch = one K-step sweep of one shard, frozen
    # ghosts): K8, K8-i16 and K7 on the 256x1024 shard of the golden runs
    # (K = 8; K7 at K = 4, its default depth when forced), K4-slab and
    # K4-slab-i16 on the 1024x4096 shard of the 4096^2 run (K = 4); the shard
    # is the last of 4 (its top row and edge columns are walls).  Bytes: the
    # body read and written once, the 2K ghost rows read once, the extended
    # slab's mask; operations: the body's fluid cells, K steps.  Tier: L2
    # for the 256x1024 shard, its body's cell-steps over the L2 copy's rate
    # at the engine's working set (K8 one copy of the extended slab, K7 two,
    # K4-slab the body's input and output).
    def ca_row(name, source, replaces, key, shard, K, storage, plain_key, **more):
        n, nx = shard
        t = ca_times[shard]
        vb = 2 if storage == "i16" else 4
        b, by = kernel_times.bound_ms(n * nx, (n - 1) * (nx - 2), K, storage,
                                      extra_bytes=2 * K * nx * (9 * vb + 1))
        per_cell = (kernel_times.BYTES_PER_CELL_STEP_I16 if storage == "i16"
                    else kernel_times.BYTES_PER_CELL_STEP)
        if n * nx <= 256 * 1024:
            tier_b, label = l2_tier_ms(n * nx, K, storage, 1 if key.startswith("K8") else 2)
            tier = f"L2 ({label} copy)"
        else:
            tier_b, tier = n * nx * per_cell / (gbps[0] * 1e9) * 1e3, "HBM"
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": ca_err[key],
                "ms": t[f"{key} K={K}"][0] / 1e3 * K, "plain_ms": t[plain_key][0] / 1e3 * K,
                "bound_ms": b, "bound_by": by, "library_ms": None, "tier": tier,
                "tier_bound_ms": tier_b, **more}

    # K4-slab's launches by the shape they ran at: 256x1024 in 5h (the
    # forced slab engine on the golden scene over 4), 1024x4096 in 6d
    # (ca-4 at 4096^2 over 4, f32 only); each with its own time and bound.
    def slab_shapes(key, storage, plain_key):
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "tier", "tier_bound_ms")
        return [{"shard": shard, "launches": n,
                 **{f: r[f] for f in fields}}
                for shard, n, r in (
                    ("256x1024 of 1024x1024 (5h)", launches[key],
                     ca_row("", "", "", key, (256, 1024), 4, storage, plain_key)),
                    ("1024x4096 of 4096x4096 (6d)", slab_6d if storage == "f32" else 0,
                     ca_row("", "", "", key, (1024, 4096), 4, storage, plain_key)))]

    ca_src = "lbm_tpu_torch/csrc/"
    # K9's slots: the plan's parts of 2048^2 at K = 4, the L2 rate at the
    # working set of its S slots.
    k9_rows, k9_slots = hbm_cuda.plan(bench.make_scene("2048x2048").params, 4)
    k9_label, k9_rate = kernel_times.l2_rate_for(l2, k9_slots * 9 * (k9_rows + 8) * 2048 * 4)
    k9_bounds = bounds(2048, 2048, 2046 ** 2, 4, "f32", "HBM")
    kernels += [
        ca_row("K4-slab ca slab sweep (ms per launch = 4 steps of one 1024x4096 shard of "
               "4096x4096, K=4; launches and times by shape under by_shard)",
               ca_src + "temporal.cu", "lbm_tpu/ops/temporal_pallas.py:535",
               "K4-slab", (1024, 4096), 4, "f32", "plain K=4", launches_6d=slab_6d,
               by_shard=slab_shapes("K4-slab", "f32", "plain K=4")),
        ca_row("K4-slab-i16 ca slab sweep, int16 state (ms per launch = 4 steps of one "
               "1024x4096 shard of 4096x4096, K=4; launches and times by shape under "
               "by_shard)", ca_src + "temporal.cu",
               "lbm_tpu/ops/temporal_pallas.py:535", "K4-slab-i16", (1024, 4096), 4, "i16",
               "plain-i16 K=4", by_shard=slab_shapes("K4-slab-i16", "i16", "plain-i16 K=4")),
        ca_row("K7 ca resident sweep (ms per launch = 8 steps of one 256x1024 shard of "
               "1024x1024, K=8, the f32 ca default there)", ca_src + "ca_resident.cu",
               "lbm_tpu/ops/resident_pallas.py:1192", "K7", (256, 1024), 8, "f32", "plain K=8",
               launches_5n=pod_launches["K7"]),
        ca_row("K8 ca in-place sweep (ms per launch = 8 steps of one 256x1024 shard of "
               "1024x1024, K=8)", ca_src + "ca_inplace.cu",
               "lbm_tpu/ops/resident_pallas.py:1643", "K8", (256, 1024), 8, "f32", "plain K=8"),
        ca_row("K8-i16 ca in-place sweep, int16 state (ms per launch = 8 steps of one 256x1024 "
               "shard of 1024x1024, K=8)", ca_src + "ca_inplace.cu",
               "lbm_tpu/ops/resident_pallas.py:1643", "K8-i16", (256, 1024), 8, "i16",
               "plain-i16 K=8"),
        {"name": f"K9 HBM-parts sweep (ms per launch = 4 steps of 2048x2048 as "
                 f"{2048 // k9_rows} parts of {k9_rows} rows in {k9_slots} L2 slots, K=4, "
                 "one launch a sweep; tier: its cell-steps' state traffic over the L2 copy's "
                 "rate at its slots' working set, hbm_tier_bound_ms: the state once from HBM)",
         "route": "cuda", "source": "lbm_tpu_torch/csrc/hbm.cu",
         "replaces": "lbm_tpu/ops/hbm_pallas.py:157", "launches": launches["K9"],
         "max_abs_err": k9_err, "ms": hbm_times["K9 K=4"][0] / 1e3 * 4,
         "plain_ms": sweeps[2048]["plain K=4"][0] / 1e3 * 4,
         **k9_bounds, "hbm_tier_bound_ms": k9_bounds["tier_bound_ms"],
         "tier": f"L2 ({k9_label} copy: {k9_slots} slots of {k9_rows + 8}x2048)",
         "tier_bound_ms": kernel_times.hbm_tier_ms(2048, 4, k9_rate)},
        {"name": f"K10 two-copy row-block kernel (ms per launch = {chunk} steps, 1024x1024, "
                 f"B={blocked_cuda.DEFAULT_BLOCK_ROWS}; its two copies, 72 MiB, stream from HBM)",
         "route": "cuda", "source": "lbm_tpu_torch/csrc/blocked.cu",
         "replaces": "lbm_tpu/ops/resident_pallas.py:480", "launches": launches["K10"],
         "max_abs_err": k10_err,
         "ms": blocked_times[f"K10 B={blocked_cuda.DEFAULT_BLOCK_ROWS}"][0] / 1e3 * chunk,
         "plain_ms": blocked_times["plain K10"][0] / 1e3 * chunk,
         **bounds(1024, 1024, 1022 ** 2, chunk, "f32", "HBM"),
         # Its copies do not fit L2, so every step reads and writes HBM.
         "tier_bound_ms": chunk * 1024 * 1024 * kernel_times.BYTES_PER_CELL_STEP
         / (gbps[0] * 1e9) * 1e3},
    ]
    print(f"[7 elapsed] card: {card} | {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
