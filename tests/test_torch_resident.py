"""The work map of the two-copy resident kernels, K2 (csrc/resident.cu, a
periodic grid) and K6 (csrc/ghosted.cu, a shard between two frozen ghost
rows), on the CPU: the host band plan they run on
(``resident_cuda.grid_plan`` and ``ghosted_cuda.shard_plan``, both
``inplace_cuda.band_plan``) and the partials buffer their wrappers build.

Two copies add a hazard to K3's in-place one: at step t + 1 a block
overwrites the copy its neighbours read at step t (write after read), as
well as reading what they wrote (read after write).  The kernels wait on
one dependency set for both (csrc/two_copy.cuh); these tests hold the plan
to that: each block's waits cover every block whose cells lie within one
row of its own, both ways, and every block the cells it reads or writes
meet.  They also walk the cells as the kernel does (a band per block, two
cells a thread per round, rows and columns from counters) and check that
every cell is computed once per step, at its own row and column.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import ghosted_cuda, inplace_cuda, resident_cuda

THREADS, CELLS = 256, 2  # csrc/lbm_common.cuh kThreads, csrc/aa_inplace.cuh kCells

# (rows, nx, blocks): the 128^2-768^2 grids at the card's block counts
# (one block per 256 cells, at most 528 resident), bands ending mid-row
# (129 and 1000 columns), odd nx, cell counts the blocks do not divide,
# bands wider than a row and narrower than one, and one block.
K2_CASES = [(128, 128, 64), (256, 256, 256), (512, 512, 528), (768, 768, 528),
            (30, 129, 16), (7, 1000, 28), (45, 33, 6), (61, 99, 24), (3, 33, 2), (5, 6, 1)]
# K6: the 256x1024 shard of the golden grid over 4, the 13x100 and 8x1024
# shards of the card checks, one- and two-row shards.
K6_CASES = [(256, 1024, 528), (13, 100, 6), (8, 1024, 32), (30, 129, 16), (9, 33, 2),
            (2, 65, 1), (1, 100, 1), (1, 1000, 4)]


def _deps(entry, grid):
    _, _, lo, n = entry
    return {(lo + d) % grid for d in range(n)}


def _rows_of(entry, nx):
    s, e, _, _ = entry
    return s // nx, (e - 1) // nx


def _near(a, b, rows, periodic):
    """Whether rows [a0, a1] and [b0, b1] lie within one row of each other
    (y wrapping over ``rows`` rows for a periodic grid)."""
    (a0, a1), (b0, b1) = a, b
    if not periodic:
        return a0 <= b1 + 1 and b0 <= a1 + 1
    return any(((r - b0) % rows) <= (b1 - b0) for r in range(a0 - 1, a1 + 2))


def _check_plan(plan, rows, nx, grid, periodic):
    assert len(plan) == 1 and len(plan[0]) == grid
    entries = plan[0]
    # Every cell once per step: the bands tile the cells in block order,
    # each inner end on a 32-cell line (resident_cuda.BAND_ALIGN).
    assert entries[0][0] == 0 and entries[-1][1] == rows * nx
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(entries, entries[1:]))
    assert all(s % resident_cuda.BAND_ALIGN == 0 for s, _, _, _ in entries)
    assert all(0 < n <= grid for _, _, _, n in entries)
    # Within one row, both ways (the hazards' superset).
    spans = [_rows_of(e, nx) for e in entries]
    deps = [_deps(e, grid) for e in entries]
    for b in range(grid):
        for c in range(grid):
            if _near(spans[b], spans[c], rows, periodic):
                assert c in deps[b] and b in deps[c], (b, c, spans[b], spans[c])
    # The exact hazards: the cells a block's step reads (the 3 x 3
    # neighbourhood, x wrapping; y wrapping on the grid, the ghosts on a
    # shard, which no block writes) against the cells another one writes.
    owner = np.repeat(np.arange(grid), [e - s for s, e, _, _ in entries])
    reads = []
    for s, e, _, _ in entries:
        j, i = np.divmod(np.arange(s, e), nx)
        cells = []
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                jj, ii = j + dj, (i + di) % nx
                if periodic:
                    jj = jj % rows
                keep = (jj >= 0) & (jj < rows)
                cells.append(jj[keep] * nx + ii[keep])
        reads.append(set(np.unique(owner[np.concatenate(cells)]).tolist()))
    for b in range(grid):
        raw = reads[b]  # blocks that wrote at step t what b reads at step t + 1
        war = {c for c in range(grid) if b in reads[c]}  # blocks that read what b overwrites
        assert (raw | war) - {b} <= deps[b], (b, sorted((raw | war) - deps[b]))


@pytest.mark.parametrize("ny,nx,grid", K2_CASES)
def test_k2_plan_covers_both_hazards(ny, nx, grid):
    _check_plan(resident_cuda.grid_plan(ny, nx, grid), ny, nx, grid, periodic=True)


@pytest.mark.parametrize("n,nx,grid", K6_CASES)
def test_k6_plan_covers_both_hazards(n, nx, grid):
    _check_plan(ghosted_cuda.shard_plan(n, nx, grid), n, nx, grid, periodic=False)


@pytest.mark.parametrize("rows,nx,grid", [(1024, 1024, 528), (1021, 1023, 528), (60, 100, 24),
                                          (7, 33, 1), (45, 99, 18)])
def test_band_plan_without_alignment_is_the_even_split(rows, nx, grid):
    """``align`` is the two-copy kernels' alone: at its default of 1 the
    split K3 and K8 take is block b at [b n // grid, (b + 1) n // grid)."""
    n = rows * nx
    plan = inplace_cuda.band_plan([(0, rows)], nx, grid, rows)[0]
    assert [(s, e) for s, e, _, _ in plan] == [(b * n // grid, (b + 1) * n // grid)
                                               for b in range(grid)]
    aligned = inplace_cuda.band_plan([(0, rows)], nx, grid, rows, align=32)[0]
    assert [s - s % 32 for s, _, _, _ in plan] == [s for s, _, _, _ in aligned]
    with pytest.raises(ValueError, match="alignment"):
        inplace_cuda.band_plan([(0, 2)], 100, 8, 2, align=32)


def _walk(entry, nx):
    """The cells one block computes in a step, as csrc/two_copy.cuh walks
    them: thread t starts at start + t, takes CELLS cells THREADS apart a
    round, and keeps its row and column with counters; yields (cell, row,
    column) in the kernel's order."""
    s, e, _, _ = entry
    dj, di = divmod(THREADS, nx)
    for t in range(THREADS):
        c_first = s + t
        j, i = divmod(c_first, nx)
        for c0 in range(c_first, e, CELLS * THREADS):
            for m in range(CELLS):
                c = c0 + m * THREADS
                if c < e:
                    yield c, j, i
                i, j = i + di, j + dj
                if i >= nx:
                    i, j = i - nx, j + 1


@pytest.mark.parametrize("rows,nx,grid,form", [(30, 129, 16, "K2"), (7, 1000, 28, "K2"),
                                               (45, 33, 6, "K2"), (5, 6, 1, "K2"),
                                               (13, 100, 6, "K6"), (1, 1000, 4, "K6"),
                                               (2, 65, 1, "K6")])
def test_two_copy_walk_computes_each_cell_once(rows, nx, grid, form):
    plan = (resident_cuda.grid_plan(rows, nx, grid) if form == "K2"
            else ghosted_cuda.shard_plan(rows, nx, grid))
    seen = []
    for entry in plan[0]:
        for c, j, i in _walk(entry, nx):
            assert (j, i) == divmod(c, nx)
            seen.append(c)
    assert sorted(seen) == list(range(rows * nx))


@pytest.mark.parametrize("form,rows,nx,grid,chunk", [("K2", 256, 256, 256, 256),
                                                     ("K2", 30, 129, 16, 3),
                                                     ("K6", 256, 1024, 528, 2),
                                                     ("K6", 13, 100, 6, 8)])
def test_two_copy_partials_layout(form, rows, nx, grid, chunk):
    """The buffer the wrappers pass as ``partials``: grid step counters
    at zero, each on a 128-byte line of its own (32 words), then the plan
    (grid x 4 int32: start, end, dep_lo, dep_n), then chunk x grid sums."""
    plan = (resident_cuda.grid_plan(rows, nx, grid) if form == "K2"
            else ghosted_cuda.shard_plan(rows, nx, grid))
    buf = resident_cuda.partials_buffer(plan, chunk, "cpu")
    head = resident_cuda.COUNTER_WORDS * grid
    assert resident_cuda.COUNTER_WORDS * 4 == 128
    assert buf.dtype == torch.float32
    assert buf.numel() == head + 4 * grid + chunk * grid
    words = buf.view(torch.int32)
    assert not words[:head].any()
    assert words[head:head + 4 * grid].reshape(grid, 4).tolist() == [list(e) for e in plan[0]]


def test_k6_plan_waits_stay_local_on_the_golden_shard():
    """On the 256x1024 shard of the golden grid over 4 at the card's 528
    blocks, a band is about half a row: each block waits for the blocks of
    its rows and the rows next to them, at most 10 of the 528; the first
    and last rows' blocks wait on no block past the ghosts."""
    plan = ghosted_cuda.shard_plan(256, 1024, 528)[0]
    assert max(n for _, _, _, n in plan) <= 10
    assert plan[0][2] == 0 and plan[-1][2] + plan[-1][3] == 528
