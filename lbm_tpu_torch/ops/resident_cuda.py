"""K2: the persistent multi-step CUDA kernel (csrc/resident.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_chunk_kernel`` (:213, entries
``make_chunk_runner`` :766 and ``make_run_all`` :925), f32 path.  One
cooperative launch runs ``chunk`` steps, ping-ponging between two device
buffers, so the state stays in the card's 50 MB L2 for the whole chunk;
between steps a block waits only for the blocks within one row of its
cells, on K3's band plan (``inplace_cuda.band_plan`` over ny periodic
rows, in the partials buffer beside the blocks' step counters:
:func:`partials_buffer`).

Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, from L2
instead of device memory while both copies fit, plus each step's wait.  The
program picks it only where ``2 x 9 x ny x nx x 4`` bytes fit
:data:`L2_STATE_BUDGET` (see the notes at the top of csrc/resident.cu and
csrc/two_copy.cuh).

Beside the kernel:

- the plain version, :func:`run_plain`: a loop of the twin step
  (ops/fused_torch.py) returning per-step tot_u, which the kernel matches
  bitwise on fields.

Launches count in ``_build.LAUNCHES`` under ``K2``, one a chunk.  A wrapper
takes the plain version only for a tensor on the CPU.  For a CUDA tensor it
launches the kernel or raises; it never falls back (ops/_runner.py).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, inplace_cuda
from lbm_tpu_torch.params import LBMParams

DEFAULT_CHUNK = 256

# Two f32 copies of the state must fit this many bytes for the multi-step
# kernel to be chosen: up to 768^2 (40.5 MiB), where K2 measured 12.86
# us/step against K1's 14.81 and K3's 14.0-14.6 (PERF.md, Findings PR 2).
L2_STATE_BUDGET = 42 * 2**20


def fits_l2(ny: int, nx: int) -> bool:
    """Whether the two ping-pong copies of a (9, ny, nx) f32 state fit
    :data:`L2_STATE_BUDGET`."""
    return 2 * 9 * ny * nx * 4 <= L2_STATE_BUDGET


# The two-copy kernels' bands start on multiples of this many cells: a
# warp's 32 float32 values, one 128-byte line.  On the card it took K2 at
# 512^2 from 5.45 to 4.70-4.84 us/step and at 768^2 from 12.0-12.1 to
# 10.7-10.9, K6 on the 256x1024 shard from 15.3 to 12.9 us a 2-step launch
# (PERF.md, Findings PR 10).
BAND_ALIGN = 32


# 32-bit words per step counter of the two-copy kernels: a 128-byte line
# each (csrc/two_copy.cuh kCounterWords).  Packed 32 to a line, every
# block's polls and releases met on a few lines: K2 at 256^2 ran 2.65-2.77
# us/step and swung with where its buffers landed, 2.21 with a line each
# (PERF.md, Findings PR 10).
COUNTER_WORDS = 32


def partials_buffer(plan: list, sum_steps: int, device, counters: int | None = None
                    ) -> torch.Tensor:
    """The partials buffer of the two-copy kernels K2, K6 and K7
    (csrc/two_copy.cuh), float32 words: the grid step counters
    :data:`COUNTER_WORDS` apart, zero; the band plan (steps x grid x 4
    int32: start, end, dep_lo, dep_n; one step for K2 and K6, whose every
    step takes the same split, K for K7); then sum_steps x grid sums.
    ``counters``: the number of counters when it is not the plan's grid
    (K9: one more, its count of blocks done with a part)."""
    grid = len(plan[0])
    head = COUNTER_WORDS * (counters or grid)
    words = 4 * len(plan) * grid
    buf = torch.zeros(head + words + sum_steps * grid, dtype=torch.float32)
    buf.view(torch.int32)[head:head + words] = torch.tensor(plan, dtype=torch.int32).flatten()
    return buf.to(device)


def grid_plan(ny: int, nx: int, grid: int) -> list[list[tuple[int, int, int, int]]]:
    """K2's band plan (``inplace_cuda.band_plan``, one entry per block,
    the same every step): the ny x nx grid's cells split evenly over
    ``grid`` blocks in bands aligned to :data:`BAND_ALIGN` cells, each
    waiting for the blocks whose cells lie within one row of its own, y
    wrapping."""
    return inplace_cuda.band_plan([(0, ny)], nx, grid, ny, align=BAND_ALIGN)


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int):
    """The plain version of K2: ``num_steps`` twin steps, per-step tot_u."""
    return fused_torch.run_steps(f, obstacles, params, num_steps)


def make_run_all(
    params: LBMParams, obstacles: torch.Tensor, num_steps: int, chunk: int = DEFAULT_CHUNK,
    lib=None,
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K2 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all``).

    Both state buffers and the partials (the blocks' step counters, the
    band plan and chunk x blocks sums: :func:`partials_buffer`) are
    allocated here, once.  ``f0`` is not modified.  On the card the
    returned state is one of the runner's buffers and stays valid until the
    runner's next call.  ``lib`` is the kernel library (``_build.load()``
    by default; ``_build.load_variant`` gives another version of the kernel
    to time)."""
    chunks = _runner.chunk_lengths(num_steps, chunk)

    def card(lib):
        dev = obstacles.device
        grid = _runner.cooperative_grid(lib, "lbm_resident_grid", "K2", dev, params.ny,
                                        params.nx)
        shape = (9, params.ny, params.nx)
        fa = torch.empty(shape, dtype=torch.float32, device=dev)
        fb = torch.empty(shape, dtype=torch.float32, device=dev)
        partials = partials_buffer(grid_plan(params.ny, params.nx, grid), max(chunks, default=1),
                                   dev)
        omega, w1, w2 = fused_torch.step_constants(params)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            fa.copy_(f)
            src, dst, done = fa, fb, 0
            stream = torch.cuda.current_stream(dev).cuda_stream
            for n in chunks:
                _build.launch(
                    lib, "lbm_resident_chunk", "K2", src.data_ptr(), dst.data_ptr(),
                    obstacles.data_ptr(), partials.data_ptr(), tot.data_ptr() + 4 * done,
                    params.ny, params.nx, params.accel_row, omega, w1, w2, n, grid, stream,
                    dev.index,
                )
                if n % 2:
                    src, dst = dst, src
                done += n
            return src, tot

        return run_all

    return _runner.card_or_plain(
        params, obstacles, lambda f: run_plain(f, obstacles, params, num_steps), card, lib=lib)
