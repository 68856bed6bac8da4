"""K5: the skewed K-step temporal sweep (csrc/skew.cu) and its wrappers.

Replaces ``lbm_tpu/ops/skew_pallas.py::_skew_kernel`` (:211, entries
``make_pair`` :529 and ``make_run_all`` :597), float32 state (K5) and int16
state (K5-i16, ``storage="i16"``).  One launch advances the grid K steps:
each block walks a band of rows of a column strip upward, R = 2 rows of
every level per walk step and one block barrier per step, keeping the last
rows of every level in shared memory, so every row of every level is
computed once per band and the state crosses device memory once per K
steps.  Each thread owns one (level, column) pair of the strip for the
whole walk, and the strip's width makes the pairs fill the block
(:func:`strip_width`), so every walk step is one round on every thread;
level-0 rows arrive by asynchronous copies two steps ahead of their first
use.  Level K is written at its true position, so each sweep is K steps
on the canonical state: the TPU's rotated forward sweep and mirrored
reverse sweep have no counterpart (the note at the top of csrc/skew.cu).
``make_run_all`` runs whole sweeps, then the remainder as K1 (or K1-i16)
steps.

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps`` (as
  K4's), which the kernel matches bitwise on fields;
- the host's model of the walk, :func:`walk_plan` and :func:`thread_pairs`,
  which the CPU tests hold to every hazard of the rings;
- :func:`band_rows`, the band height that fills the card's slots.

Launches count in ``_build.LAUNCHES`` under ``K5`` and ``K5-i16``, one a
sweep.  A wrapper takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises; it never falls back
(ops/_runner.py).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, quant, temporal_cuda
from lbm_tpu_torch.params import LBMParams

ROWS_PER_STEP = 2  # R: rows of every level per walk step (kR in csrc/skew.cu)
PREFETCH = 1  # steps between a level-0 copy's issue and the barrier it lands by (kPrefetch)
RING = 2 * ROWS_PER_STEP + 2  # rows kept per level 1 .. K-1 (kRing)
RING0 = (PREFETCH + 2) * ROWS_PER_STEP + 2  # level-0 rows kept (kRing0)
BAND_MAX = 192  # the tallest band the host gives a block (its walls' shared memory)
# The one-row walk's strips and bands, for a library that lacks
# lbm_skew_grid (an earlier version of csrc/skew.cu timed in turns).
LEGACY_GEOMETRY = (64, 128)

run_plain = temporal_cuda.run_plain


def threads(K: int) -> int:
    """Threads per block at depth K: 256 to K = 4, 512 above (more
    threads keep the strip wide as the halo grows)."""
    return 256 if K <= 4 else 512


def strip_pairs(K: int, tw: int) -> int:
    """(level, column) pairs of a strip of ``tw`` output columns: level l
    computes columns [l, tw + 2K - l)."""
    return K * (tw + 2 * K) - K * (K + 1)


def strip_width(K: int) -> int:
    """Output columns of a strip at depth K: the widest whose pairs fit
    :func:`threads`, so that every thread but at most K - 1 owns one
    (0 where none fits)."""
    return max(0, (threads(K) + K * (K + 1)) // K - 2 * K)


def thread_pairs(K: int, tw: int) -> list[tuple[int, int]]:
    """The (level, column) pair of each thread, as the kernel assigns them
    (level by level, columns [l, cw - l) of level l, cw = tw + 2K)."""
    cw = tw + 2 * K
    return [(lv, c) for lv in range(1, K + 1) for c in range(lv, cw - lv)]


def walk_steps(K: int, bh: int) -> int:
    """Walk steps of a band of ``bh`` output rows: ceil(rows / R) + K,
    rows = bh + 2K level-0 rows."""
    return -(-(bh + 2 * K) // ROWS_PER_STEP) + K


def walk_plan(K: int, bh: int) -> dict:
    """The schedule of one band's walk, as csrc/skew.cu runs it, rows q
    counted from the band's first level-0 row (grid row y0 - K):

    - ``prologue``: the level-0 rows copied before step 0 (chunks 0 .. D-1
      of R rows, each with its ring slot);
    - ``steps[s]``: ``copies`` (chunk s + D, issued at step s), ``landed``
      (chunk s, complete at the barrier ending step s) and ``cells``:
      ``(level, row, reads, write)``,
      ``reads`` the three (level, row, slot) it pulls, ``write`` the (level,
      row, slot) it stores (slot None for level K: device memory).

    R = ROWS_PER_STEP and D = PREFETCH; level 0 keeps rows in slot q mod
    :data:`RING0`, levels 1 .. K-1 in q mod :data:`RING`; each cell stands
    for every column of its level."""
    R, D, rows = ROWS_PER_STEP, PREFETCH, bh + 2 * K

    def slot(lv, q):
        return q % (RING0 if lv == 0 else RING)

    def chunk(ch):
        return [(q, slot(0, q)) for q in range(ch * R, min(ch * R + R, rows))]

    steps = []
    for s in range(-(-rows // R) + K):
        cells = []
        for lv in range(1, K + 1):
            a = s * R - lv * (R + 1)
            for q in range(a, a + R):
                if lv <= q < rows - lv:
                    reads = [(lv - 1, q + d, slot(lv - 1, q + d)) for d in (-1, 0, 1)]
                    cells.append((lv, q, reads, (lv, q, slot(lv, q) if lv < K else None)))
        steps.append({"copies": chunk(s + D), "landed": [q for q, _ in chunk(s)],
                      "cells": cells})
    return {"rows": rows, "prologue": [c for ch in range(D) for c in chunk(ch)], "steps": steps}


def driven_positions(ny: int, K: int, bh: int) -> set[tuple[int, int]]:
    """(level, i) for every cell of the driven row (ny - 2) an ny-row grid's
    bands compute (in their own rows or a neighbour's halo), i its place
    among the R rows of that level's walk step (:func:`walk_plan`)."""
    R = ROWS_PER_STEP
    out = set()
    for y0 in range(0, ny, bh):
        for st in walk_plan(K, bh)["steps"]:
            for lv, q, _, _ in st["cells"]:
                if (y0 - K + q) % ny == ny - 2:
                    out.add((lv, (q + lv * (R + 1)) % R))
    return out


def copy_bytes(nx: int, storage: str) -> int:
    """Bytes of each level-0 copy (copy_elements in csrc/skew.cu, on the
    runner's aligned buffers): the widest of 16, 8 and 4 whose elements
    divide nx; 0 (plain loads) for int16 with an odd nx."""
    size = 2 if storage == "i16" else 4
    for nbytes in (16, 8, 4):
        if nx % (nbytes // size) == 0:
            return nbytes
    return 0


def smem_bytes(K: int, tw: int, bh: int) -> int | None:
    """Dynamic shared memory of one K5 block (strip_smem in csrc/skew.cu),
    or None for a strip whose pairs exceed 512 threads."""
    cw, rows = tw + 2 * K, bh + 2 * K
    pairs = strip_pairs(K, tw)
    if K < 2 or tw < 1 or bh < 1 or pairs > 512:
        return None
    nt = 256 if pairs <= 256 else 512
    pitch_f32, pitch_i16 = -(-(cw + 3) // 4) * 4, -(-(cw + 7) // 8) * 8
    nw = -(-cw // 32)
    return (RING0 * 9 * max(4 * pitch_f32, 2 * pitch_i16) + (K - 1) * RING * 9 * cw * 4
            + (nt + pitch_i16 + rows + rows * nw) * 4 + rows)


def band_rows(ny: int, nx: int, K: int, slots: int) -> int:
    """Output rows of a band at depth K on a card that holds ``slots``
    blocks at once: of the heights up to :data:`BAND_MAX` that make the
    blocks fill 1, 2, ... rounds of the slots, the one whose rounds take the
    fewest walk steps in all (rounds x :func:`walk_steps`; the taller band
    on a tie)."""
    ntx = -(-nx // strip_width(K))
    best = None
    for waves in range(1, 65):
        nb = max(1, min(ny, waves * max(1, slots) // ntx))
        bh = -(-ny // nb)
        if bh <= BAND_MAX:
            cost = -(-(ntx * -(-ny // bh)) // max(1, slots)) * walk_steps(K, bh)
            if best is None or (cost, -bh) < best[:2]:
                best = (cost, -bh, bh)
        if nb == ny:
            break
    return best[2] if best else BAND_MAX


def geometry(K: int, ny: int, nx: int, lib=None) -> tuple[int, int]:
    """(strip width, band rows) of a K5 launch on the current CUDA device
    with library ``lib`` (``_build.load()`` by default): :func:`strip_width`
    and :func:`band_rows` for the card's slots; a library without
    ``lbm_skew_grid`` (the one-row walk) takes :data:`LEGACY_GEOMETRY`."""
    lib = lib or _build.load()
    if not hasattr(lib, "lbm_skew_grid"):
        return LEGACY_GEOMETRY
    tw = strip_width(K)
    slots = lib.lbm_skew_grid(K, tw, BAND_MAX)
    if slots < 1:
        raise RuntimeError(f"K5 strip of {tw} columns at K={K}: no block fits the card "
                           f"({slots})")
    return tw, band_rows(ny, nx, K, slots)


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """True when K5 can map a K-deep sweep of this grid: K >= 2, ny and nx
    at least 2K (the warm-up rows of B6's seam strip), and a strip that fits
    the block's threads and shared memory.  The driven row may lie
    anywhere."""
    quant.check_storage(storage)
    if K < 2 or params.ny < 2 * K or params.nx < 2 * K:
        return False
    need = smem_bytes(K, strip_width(K), BAND_MAX)
    return need is not None and need <= temporal_cuda.SMEM_LIMIT


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32", lib=None, strip_band: tuple[int, int] | None = None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K5 sweeps, then K1
    steps for ``num_steps mod K`` (``skew_pallas.make_run_all`` takes pairs
    of 2K steps; a sweep here is K).  ``lib`` is the kernel library
    (:func:`temporal_cuda.sweep_runner`); ``strip_band`` overrides
    (strip width, band rows), which :func:`geometry` gives otherwise."""
    if not supports(params, K, storage):
        raise ValueError(f"skewed sweep (K={K}) cannot map a {params.ny}x{params.nx} grid")
    return temporal_cuda.sweep_runner(
        "K5", "skew", lambda lib: strip_band or geometry(K, params.ny, params.nx, lib), params,
        obstacles, num_steps, K, storage, lib)


def make_sweep(params: LBMParams, obstacles: torch.Tensor, K: int, storage: str = "f32"):
    """Build ``f -> (f_after_K_steps, tot_u (K,))``: one K5 launch."""
    return make_run_all(params, obstacles, K, K, storage)
