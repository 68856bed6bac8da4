"""K10: the two-copy row-block persistent CUDA kernel (csrc/blocked.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_blocked_chunk_kernel`` (:480,
built by ``make_chunk_runner`` :766 -> ``pallas_call`` :882, entry
``make_run_all`` :925).  One cooperative launch runs ``chunk`` steps,
ping-ponging between two device copies of the float32 state on the
two-copy neighbour-wait machinery of K2 (csrc/two_copy.cuh): each step is
walked as warp tiles of B rows x 32 columns, a lane walking its column's B
rows in row order, so each (row block, column) partial of B4's |u|
grouping comes out of one register (on small grids a tile's rows are split
over 2, 4 or 8 warps of a block, whose |u| warp 0 adds in row order from
shared memory after the group's own barrier); a tile
waits only for the 3 x 3 tiles around it on their step counters, and warps
of their own sum the partials over the row blocks (see the note at the top
of csrc/blocked.cu).

On the TPU this was the ping-pong fallback of a raised scoped-VMEM limit
(``auto_raised_plan`` :165-169), which the in-place band dominated.  Here it
is forced only (``LBM_RESIDENT_KIND=blocked``, models/program.py): both
copies stay in L2 up to 768^2 and stream from HBM beyond.

Bound: 9 x 4 B read + 9 x 4 B written per cell-step, from L2 or HBM, plus
each step's wait for the neighbouring tiles and the (ny / B, nx) column
partials.

Beside the kernel:

- the plain version, :func:`run_plain` (``fused_torch.blocked_chunk``),
  which the kernel matches bitwise on fields and, through the same
  grouping of the |u| sums, on tot_u.

Launches count in ``_build.LAUNCHES`` under ``K10``, one a chunk.  A wrapper
takes the plain version only for a tensor on the CPU.  For a CUDA tensor it
launches the kernel or raises; it never falls back (ops/_runner.py).
float32 only, as B4.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

DEFAULT_CHUNK = 256
# Rows per tile (a divisor of the kernel's 256 threads; the tile is then
# 256 / B columns wide).  Any ny: the last row block is partial where B does
# not divide it.  B fixes the grouping of the |u| sums.  16 from the H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md Findings, K10; tools/kernel_times.py
# --blocked, in turns): B = 8 / 16 took 35.9 / 32.5 us/step at 1024^2, the
# grid of K10's main path, and 6.43 / 6.62 at 512^2; B = 4 and 32 were slower.
DEFAULT_BLOCK_ROWS = 16

# The kernel's step counters (csrc/blocked.cu): one per tile of B rows x
# TILE_COLUMNS columns and one per column pass of as many columns,
# COUNTER_WORDS apart (one 128-byte line each); its column partials: a ring
# of PART_SLOTS slots.
TILE_COLUMNS = 32
COUNTER_WORDS = 32
PART_SLOTS = 4


def tiles(ny: int, nx: int, block_rows: int) -> tuple[int, int]:
    """(row blocks, column tiles) of the kernel's walk."""
    return -(-ny // block_rows), -(-nx // TILE_COLUMNS)


def sync_words(ny: int, nx: int, block_rows: int) -> int:
    """32-bit words of the kernel's step counters: one line per tile and
    per column pass."""
    nby, nbw = tiles(ny, nx, block_rows)
    return (nby * nbw + nbw) * COUNTER_WORDS


def check_storage(storage: str) -> None:
    """K10 takes float32 state only, as B4 (``lbm_tpu``'s text,
    resident_pallas.py:794-798)."""
    quant.check_storage(storage)
    if storage != "f32":
        raise ValueError(
            f"storage {storage!r} maps only the in-place resident kernel (pass inplace=True)")


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              block_rows: int = DEFAULT_BLOCK_ROWS):
    """The plain version of K10: ``num_steps`` steps of
    ``fused_torch.blocked_chunk``, per-step tot_u."""
    return fused_torch.blocked_chunk(f, obstacles, params, num_steps, block_rows)


def make_run_all(
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    chunk: int = DEFAULT_CHUNK,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    storage: str = "f32",
    lib=None,
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K10 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all(..., force_blocked=True)``).

    Both state copies, the step counters (zeroed before each launch), the
    ring of column partials and the column sums are allocated here, once.
    ``f0`` is not modified.  On the card the returned state is one of the
    runner's copies and stays valid until the runner's next call.  ``lib``
    as in ``inplace_cuda.make_run_all``."""
    check_storage(storage)
    if block_rows < 1 or 256 % block_rows:
        raise ValueError(f"block_rows must divide 256, got {block_rows}")
    chunks = _runner.chunk_lengths(num_steps, chunk)

    def plain(f):
        parts = []
        for n in chunks:
            f, tot = run_plain(f, obstacles, params, n, block_rows)
            parts.append(tot)
        return f, (torch.cat(parts) if parts else torch.empty(0, dtype=torch.float32))

    def card(lib):
        dev = obstacles.device
        grid = _runner.cooperative_grid(lib, "lbm_blocked_grid", "K10", dev, params.ny,
                                        params.nx, block_rows)
        shape = (9, params.ny, params.nx)
        fa = torch.empty(shape, dtype=torch.float32, device=dev)
        fb = torch.empty(shape, dtype=torch.float32, device=dev)
        nby = -(-params.ny // block_rows)
        # The step counters, as 32-bit words (at least the (2, 9, nx) float
        # scratch row of the earlier K10, which takes this buffer in their
        # place when it is timed through this runner in turns).
        sync = torch.zeros(max(sync_words(params.ny, params.nx, block_rows), 18 * params.nx),
                           dtype=torch.int32, device=dev)
        part = torch.empty((PART_SLOTS, nby, params.nx), dtype=torch.float32, device=dev)
        colsum = torch.empty((max(chunks, default=1), params.nx), dtype=torch.float32,
                             device=dev)
        omega, w1, w2 = fused_torch.step_constants(params)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            if f.data_ptr() != fa.data_ptr():
                fa.copy_(f)
            src, dst, done = fa, fb, 0
            stream = torch.cuda.current_stream(dev).cuda_stream
            for n in chunks:
                sync.zero_()
                _build.launch(
                    lib, "lbm_blocked_chunk", "K10", src.data_ptr(), dst.data_ptr(),
                    obstacles.data_ptr(), sync.data_ptr(), part.data_ptr(), colsum.data_ptr(),
                    tot.data_ptr() + 4 * done, params.ny, params.nx, params.accel_row, omega,
                    w1, w2, n, block_rows, grid, stream, dev.index,
                )
                if n % 2:
                    src, dst = dst, src
                done += n
            return src, tot

        return run_all

    return _runner.card_or_plain(params, obstacles, plain, card, lib=lib)
