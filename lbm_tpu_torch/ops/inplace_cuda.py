"""K3: the in-place persistent multi-step CUDA kernel (csrc/inplace.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_inplace_blocked_kernel`` (:601,
entries ``make_chunk_runner`` :766 and ``make_run_all`` :925 with
``inplace=True``), float32 state (K3) and int16 state (K3-i16,
``storage="i16"``, ops/quant.py).  One cooperative launch runs ``chunk``
steps on ONE device copy of the state, updated in place, so a state whose
two copies do not fit the card's 50 MB L2 (1024^2 f32: 72 MiB) can still
stay there (36 MiB).

Bound: 9 reads + 9 writes of state per cell-step from L2 while the copy
stays there, plus each step's wait for the neighbouring blocks.  Steps
alternate between two layouts of the buffer (the AA pattern) so that every
cell reads and writes only its own slots and all cells run in parallel; a
byte per driven-row column carries the injection guard (see the notes at
the top of csrc/inplace.cu and csrc/aa_inplace.cuh).  Between the launches
of one run the buffer holds a kernel layout; a run ends in the canonical
(9, ny, nx) layout, in the state buffer for an even step count and in a
second buffer for an odd one.

The band plan (:func:`band_plan`) is host logic that K3 and K8 share, and
K2 and K6 (ops/resident_cuda.py, ops/ghosted_cuda.py) with their bands
aligned: each step's cells split evenly into one range per block, and the
blocks each range waits for before its step; it travels to the kernel in
the partials buffer (:func:`partials_buffer`; K2's and K6's own,
``resident_cuda.partials_buffer``).

Beside the kernel:

- the plain version, :func:`run_plain`: a loop of the twin step
  (ops/fused_torch.py; the int16 step for ``storage="i16"``), which the
  kernel matches bitwise on fields.

Launches count in ``_build.LAUNCHES`` under ``K3`` and ``K3-i16``, one a
chunk.  A wrapper takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises; it never falls back
(ops/_runner.py).
"""

from __future__ import annotations

import bisect

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

DEFAULT_CHUNK = 256

# One copy of the state must fit this many bytes for the program to pick K3
# (where K2 has not been picked), per storage.  f32: the 1024^2 headline
# (36 MiB); on the card K3 was faster there than K2 and K1 (22.1 us/step
# against 30.7 and 32.0 in turns).  int16: to 1024^2 (18 MiB), where K3-i16
# beat K1-i16 in turns at every grid timed (512^2: 6.20 against 7.31;
# 768^2: 12.75 against 12.99; 1024^2: 21.00 against 26.15; PERF.md §5);
# at 1536^2 (40.5 MiB) one copy no longer fits L2.
L2_INPLACE_BUDGET = 36 * 2**20
L2_INPLACE_BUDGET_I16 = 18 * 2**20


def state_bytes(ny: int, nx: int, storage: str = "f32") -> int:
    return 9 * ny * nx * (2 if storage == "i16" else 4)


def fits_l2(ny: int, nx: int, storage: str = "f32") -> bool:
    """Whether one copy of a (9, ny, nx) state fits the budget of its
    storage: :data:`L2_INPLACE_BUDGET` (f32) or
    :data:`L2_INPLACE_BUDGET_I16` (int16)."""
    budget = L2_INPLACE_BUDGET_I16 if storage == "i16" else L2_INPLACE_BUDGET
    return state_bytes(ny, nx, storage) <= budget


def band_plan(rows: list[tuple[int, int]], nx: int, grid: int, ny: int | None = None,
              align: int = 1) -> list[list[tuple[int, int, int, int]]]:
    """The work map of the AA kernels (csrc/aa_inplace.cuh) and the
    two-copy ones (csrc/two_copy.cuh), per step t and block b:
    ``(start, end, dep_lo, dep_n)``.

    Step t computes the rows ``rows[t] = (r0, r1)`` of a grid ``nx`` wide;
    its n = (r1 - r0) x nx cells split evenly, block b taking the absolute
    cells [r0 nx + b n // grid, r0 nx + (b + 1) n // grid), each inner end
    rounded down to a multiple of ``align`` (the two-copy kernels take 32:
    a warp's loads and stores then start on a 128-byte line).  The block's
    step waits for the blocks of step t - 1 whose cells lie within one row
    of its own: ``dep_n`` blocks from ``dep_lo``, cyclically modulo
    ``grid``; step 0 waits for none.  With ``ny`` the rows are periodic
    over ny rows and ``rows`` holds one entry, the split of every step
    (K3), whose step 0 waits on that same split (the previous launch's
    last step, or the previous step).  Needs at least ``grid`` cells per
    step (``align`` x ``grid`` with alignment), so that no block's range
    is empty."""
    if grid < 1 or nx < 1 or align < 1 or not rows:
        raise ValueError(f"band plan of {len(rows)} steps, nx {nx}, grid {grid}, align {align}")

    def split(r0, r1):
        n = (r1 - r0) * nx
        starts = [r0 * nx + b * n // grid for b in range(grid + 1)]
        starts[1:-1] = [x - x % align for x in starts[1:-1]]
        if any(a >= b for a, b in zip(starts, starts[1:])):
            raise ValueError(f"{n} cells cannot be split over {grid} blocks "
                             f"at an alignment of {align}")
        return starts

    plan, prev = [], None
    for t, (r0, r1) in enumerate(rows):
        starts = split(r0, r1)
        if ny is not None:
            prev = (r0, r1, starts)
        step = []
        for b in range(grid):
            s, e = starts[b], starts[b + 1]
            first, last = s // nx, (e - 1) // nx
            if prev is None:
                dep = (0, 0)
            elif ny is not None and last - first + 3 >= ny:
                dep = (0, grid)
            else:
                p0, p1, pstarts = prev
                if ny is not None:
                    lo_row, hi_row = (first - 1) % ny, (last + 1) % ny
                else:
                    lo_row, hi_row = max(first - 1, p0), min(last + 1, p1 - 1)
                # The blocks of the previous split that hold those rows' ends.
                lo = bisect.bisect_right(pstarts, lo_row * nx) - 1
                hi = bisect.bisect_right(pstarts, hi_row * nx + nx - 1) - 1
                dep = (lo, (hi - lo) % grid + 1)
            step.append((s, e) + dep)
        plan.append(step)
        prev = (r0, r1, starts)
    return plan


def partials_words(plan_steps: int, grid: int, sum_steps: int) -> int:
    """32-bit words of an AA kernel's partials buffer: the plan
    (plan_steps x grid x 4), grid step counters, sum_steps x grid sums."""
    return 4 * plan_steps * grid + grid + sum_steps * grid


def partials_buffer(plan: list, sum_steps: int, device) -> torch.Tensor:
    """The partials buffer of an AA kernel (csrc/aa_inplace.cuh): float32
    words, the plan (int32) at the head, the step counters zero, the sums
    after them."""
    grid = len(plan[0])
    buf = torch.zeros(partials_words(len(plan), grid, sum_steps), dtype=torch.float32)
    buf.view(torch.int32)[:4 * len(plan) * grid] = torch.tensor(plan, dtype=torch.int32).flatten()
    return buf.to(device)


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              storage: str = "f32"):
    """The plain version of K3: ``num_steps`` twin steps, per-step tot_u."""
    return fused_torch.run_steps(f, obstacles, params, num_steps, storage)


def make_run_all(
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    chunk: int = DEFAULT_CHUNK,
    storage: str = "f32",
    lib=None,
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K3 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all(..., inplace=True)``).

    The state buffer (and, for an odd ``num_steps``, the second buffer the
    last step writes), the guard bytes and the partials (the band plan, the
    blocks' step counters and chunk x blocks sums: :func:`partials_buffer`)
    are allocated here, once.  ``f0`` is not modified: it is copied into the
    state buffer, unless it is that buffer (the previous call's result, as
    the driver passes segment to segment).  On the card the returned state
    is one of the runner's buffers and stays valid until its next call.
    ``lib`` is the kernel library (``_build.load()`` by default;
    ``_build.load_variant`` gives another version of the kernel to time)."""
    quant.check_storage(storage)
    chunks = _runner.chunk_lengths(num_steps, chunk)
    kernel = _runner.form("K3", storage)

    def card(lib):
        dev = obstacles.device
        i16, codec = _runner.codec_arg(params, storage)
        grid = _runner.cooperative_grid(lib, "lbm_inplace_grid", kernel, dev, params.ny,
                                        params.nx, i16)
        shape = (9, params.ny, params.nx)
        dtype = _runner.STATE_DTYPES[storage]
        state = torch.empty(shape, dtype=dtype, device=dev)
        spare = torch.empty(shape, dtype=dtype, device=dev) if num_steps % 2 else state
        gate = torch.empty((2, params.nx), dtype=torch.uint8, device=dev)
        partials = partials_buffer(band_plan([(0, params.ny)], params.nx, grid, params.ny),
                                   max(chunks, default=1), dev)
        omega, w1, w2 = fused_torch.step_constants(params)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            if num_steps == 0:
                return f, tot
            if f.data_ptr() != state.data_ptr():
                state.copy_(f)
            done = 0
            stream = torch.cuda.current_stream(dev).cuda_stream
            for n in chunks:
                _build.launch(
                    lib, "lbm_inplace_chunk", kernel, state.data_ptr(), spare.data_ptr(),
                    obstacles.data_ptr(), gate.data_ptr(), partials.data_ptr(),
                    tot.data_ptr() + 4 * done, params.ny, params.nx, params.accel_row, omega,
                    w1, w2, i16, _runner.codec_ptr(codec), done, n, int(done == 0),
                    int(done + n == num_steps), grid, stream, dev.index,
                )
                done += n
            return spare, tot

        return run_all

    return _runner.card_or_plain(
        params, obstacles, lambda f: run_plain(f, obstacles, params, num_steps, storage), card,
        storage, lib)
