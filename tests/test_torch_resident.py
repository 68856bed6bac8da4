"""The work map of the two-copy resident kernels, K2 (csrc/resident.cu, a
periodic grid), K2-batch (the same file: B instances, a group of G blocks
each, ops/ensemble_cuda.py), K6 (csrc/ghosted.cu, a shard between two
frozen ghost rows) and K7 (csrc/ca_resident.cu, a ca shard's
ghost-extended slab), on
the CPU: the host band plan they run on (``resident_cuda.grid_plan``,
``ghosted_cuda.shard_plan`` and ``ca_cuda.resident_plan``, all
``inplace_cuda.band_plan``) and the partials buffer their wrappers build.

Two copies add a hazard to K3's in-place one: at step t + 1 a block
overwrites the copy its neighbours read at step t (write after read), as
well as reading what they wrote (read after write).  The kernels wait on
one dependency set for both (csrc/two_copy.cuh); these tests hold the plan
to that: each block's waits cover every block whose cells lie within one
row of its own, both ways, and every block the cells it reads or writes
meet, also where two steps split their rows differently (K7: step t
computes the rows [t + 1, ext - t - 1)).  They also walk the cells as the
kernel does (a band per block, two cells a thread per round, rows and
columns from counters) and check that every cell is computed once per
step, at its own row and column.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import ca_cuda, ensemble_cuda, ghosted_cuda, inplace_cuda, resident_cuda

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
    _check_split(plan[0], 0, rows, nx, grid)
    _check_hazards(plan[0], plan[0], rows, nx, grid, periodic)


def _check_split(entries, r0, r1, nx, grid, waits=True):
    """Every cell of rows [r0, r1) once: the bands tile them in block
    order, each inner end on a 32-cell line (resident_cuda.BAND_ALIGN);
    each block waits on 1 to grid blocks (``waits``), or on none."""
    assert len(entries) == grid
    assert entries[0][0] == r0 * nx and entries[-1][1] == r1 * nx
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(entries, entries[1:]))
    assert all(s % resident_cuda.BAND_ALIGN == 0 for s, _, _, _ in entries[1:])
    assert all((0 < n <= grid) if waits else n == 0 for _, _, _, n in entries)


def _check_hazards(prev, cur, rows, nx, grid, periodic):
    """The waits of step t + 1's split ``cur`` on the blocks of step t's
    split ``prev`` (the same split for K2 and K6) over a state of ``rows``
    rows: within one row, both ways (the hazards' superset), and the exact
    hazards: the cells a block's step reads (the 3 x 3 neighbourhood, x
    wrapping; y wrapping on the periodic grid, the ghosts on a shard, which
    no block writes) against the cells the other step's blocks write."""
    deps = np.zeros((grid, grid), dtype=bool)  # deps[b, q]: cur's b waits on prev's q
    for b, (_, _, lo, n) in enumerate(cur):
        deps[b, (lo + np.arange(n)) % grid] = True
    spans = [np.array([_rows_of(e, nx) for e in es]) for es in (cur, prev)]
    if periodic:
        near = np.array([[_near(tuple(a), tuple(c), rows, True) for c in spans[1]]
                         for a in spans[0]])
    else:
        (a0, a1), (c0, c1) = spans[0].T, spans[1].T
        near = (a0[:, None] <= c1[None, :] + 1) & (c0[None, :] <= a1[:, None] + 1)
    assert not (near & ~deps).any(), np.argwhere(near & ~deps)[:5].tolist()

    def owners(entries):
        own = np.full(rows * nx, -1)
        for b, (s, e, _, _) in enumerate(entries):
            own[s:e] = b
        return own

    own_cur, own_prev = owners(cur), owners(prev)

    def neighbours(entries):
        """(cell, neighbour) pairs of the cells of a split."""
        cells = np.arange(entries[0][0], entries[-1][1])
        j, i = np.divmod(cells, nx)
        out = []
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                jj, ii = j + dj, (i + di) % nx
                if periodic:
                    jj = jj % rows
                keep = (jj >= 0) & (jj < rows)
                out.append(np.stack([cells[keep], jj[keep] * nx + ii[keep]]))
        return np.concatenate(out, axis=1)

    # Read after write: cur's b reads what prev's q wrote.
    x, y = neighbours(cur)
    raw = np.zeros_like(deps)
    hit = own_prev[y] >= 0
    raw[own_cur[x[hit]], own_prev[y[hit]]] = True
    # Write after read: cur's b overwrites what prev's q read.
    y, x = neighbours(prev)
    war = np.zeros_like(deps)
    hit = own_cur[x] >= 0
    war[own_cur[x[hit]], own_prev[y[hit]]] = True
    bad = (raw | war) & ~deps
    np.fill_diagonal(bad, False)  # a block's own steps follow in program order
    assert not bad.any(), np.argwhere(bad)[:5].tolist()


@pytest.mark.parametrize("ny,nx,grid", K2_CASES)
def test_k2_plan_covers_both_hazards(ny, nx, grid):
    _check_plan(resident_cuda.grid_plan(ny, nx, grid), ny, nx, grid, periodic=True)


# K2-batch: (ny, nx, B, resident blocks): 37 instances of 128^2 (groups
# of 14), 16 of 128^2 (33), 8 of 256^2 (66), the 60x100 and 30x129 shapes
# of the card checks, a geometry batch's 3 of 128^2 (64: K2's own grid),
# and a group of one block.
K2_BATCH_CASES = [(128, 128, 37, 528), (128, 128, 16, 528), (256, 256, 8, 528),
                  (60, 100, 3, 528), (30, 129, 5, 40), (128, 128, 3, 528), (16, 32, 4, 4)]


@pytest.mark.parametrize("ny,nx,B,resident", K2_BATCH_CASES)
def test_k2_batch_groups_wait_inside_their_instance(ny, nx, B, resident):
    """Each instance's group runs K2's plan of G blocks, which covers both
    hazards of two copies over its own periodic rows ("within one row",
    both ways); every wait of the launch stays inside the waiting block's
    group (a cell of row 0 waits on the blocks of its own instance's row
    ny - 1); the groups fit the resident blocks; and instance b's slice of
    the partials is K2's buffer for G blocks."""
    G = ensemble_cuda.group_blocks(ny, nx, B, resident)
    assert 1 <= G and B * G <= resident
    plan = resident_cuda.grid_plan(ny, nx, G)
    _check_plan(plan, ny, nx, G, periodic=True)
    waits = ensemble_cuda.batch_waits(plan, B)
    assert len(waits) == B * G
    for gb, ws in enumerate(waits):
        b = gb // G
        assert ws and all(b * G <= q < (b + 1) * G for q in ws), (gb, sorted(ws))
    # The wrap: the blocks holding row 0 wait on those holding row ny - 1.
    first = [gb for gb in range(G) if plan[0][gb][0] < nx]
    last = {gb for gb in range(G) if plan[0][gb][1] > (ny - 1) * nx}
    for b in range(B):
        assert all({b * G + q for q in last} <= waits[b * G + gb] for gb in first)
    buf, words = ensemble_cuda.batch_partials(ny, nx, B, G, 7)
    one = resident_cuda.partials_buffer(plan, 7, "cpu")
    assert words == one.numel() and buf.numel() == B * words
    for b in range(B):
        assert torch.equal(buf[b * words:(b + 1) * words], one)


def test_k2_batch_group_blocks_and_kernel_choice():
    """G is K2's one block per 256 cells capped at resident // B; the
    ensemble takes K2-batch where G is at least 3 and 9 planes stay within
    32-bit offsets (it beat K1-batch at every shape timed there, in L2 and
    beyond, and won no more with one or two blocks an instance), else
    K1-batch."""
    assert ensemble_cuda.group_blocks(128, 128, 1, 528) == 64
    assert ensemble_cuda.group_blocks(128, 128, 37, 528) == 14
    assert ensemble_cuda.group_blocks(128, 128, 529, 528) == 0
    assert ensemble_cuda.kernel_choice(128, 128, 37, 528) == "K2-batch"
    assert ensemble_cuda.kernel_choice(1024, 1024, 4, 528) == "K2-batch"
    assert ensemble_cuda.kernel_choice(64, 64, 176, 528) == "K2-batch"  # G = 3
    assert ensemble_cuda.kernel_choice(64, 64, 177, 528) == "K1-batch"  # G = 2
    assert ensemble_cuda.kernel_choice(64, 64, 528, 528) == "K1-batch"  # G = 1
    assert ensemble_cuda.kernel_choice(256, 256, 400, 528) == "K1-batch"
    assert ensemble_cuda.kernel_choice(64, 64, 600, 528) == "K1-batch"
    assert ensemble_cuda.kernel_choice(16384, 14564, 1, 528) == "K1-batch"


@pytest.mark.parametrize("n,nx,grid", K6_CASES)
def test_k6_plan_covers_both_hazards(n, nx, grid):
    _check_plan(ghosted_cuda.shard_plan(n, nx, grid), n, nx, grid, periodic=False)


def _k7_grid(n, nx, K, sms=132, per_sm=4):
    """K7's blocks on an H100 (132 SMs, 4 blocks of 256 a SM): the card's
    cooperative grid for the extended slab, capped by ``ca_cuda.resident_grid``."""
    ext = n + 2 * K
    return ca_cuda.resident_grid(min(-(-ext * nx // 256), sms * per_sm), n, nx)


# K7: the ca shards of the golden grid over 16 and 4 (64x1024, 256x1024) at
# the policy's depths, and the card tests' 8x100, 13x128 and 40x256 shards.
K7_CASES = ([(64, 1024, K) for K in (4, 8)] + [(256, 1024, K) for K in (4, 8)]
            + [(n, nx, K) for n, nx in ((8, 100), (13, 128), (40, 256)) for K in (2, 3, 4, 8)
               if n >= K])


@pytest.mark.parametrize("n,nx,K", K7_CASES, ids=str)
def test_k7_plan_covers_both_hazards(n, nx, K):
    """K7's plan (``ca_cuda.resident_plan`` on the grid ``resident_grid``
    chooses): step t splits the rows still exact, [t + 1, ext - t - 1), in
    32-cell-aligned bands, afresh; step t + 1's waits on step t's blocks
    cover both hazards of two copies, block by block, though the two steps
    split their rows differently; step 0 reads only the windows."""
    ext = n + 2 * K
    grid = _k7_grid(n, nx, K)
    plan = ca_cuda.resident_plan(ext, nx, K, grid)
    assert len(plan) == K and all(n_dep == 0 for *_, n_dep in plan[0])
    for t, step in enumerate(plan):
        _check_split(step, t + 1, ext - t - 1, nx, grid, waits=t > 0)
        if t:
            assert [s for s, *_ in step] != [s for s, *_ in plan[t - 1]]  # splits differ
            _check_hazards(plan[t - 1], step, ext, nx, grid, periodic=False)


def test_k7_grid_leaves_every_block_a_line_on_the_last_step():
    """The grid is capped so that the last, smallest step (the n x nx body)
    gives every block at least 32 cells: the card tests' 8x100 shard at
    K = 2 takes at most 25 blocks; a shard narrower than a line, one."""
    assert ca_cuda.resident_grid(528, 8, 100) == 25
    assert _k7_grid(8, 100, 2) == 5  # ceil(12 x 100 / 256)
    assert ca_cuda.resident_grid(528, 2, 8) == 1
    assert ca_cuda.resident_plan(6, 8, 2, 1)[1] == [(16, 32, 0, 1)]  # the body, rows 2-3
    assert _k7_grid(256, 1024, 8) == 528
    for n, nx, K in K7_CASES:
        grid = _k7_grid(n, nx, K)
        assert min(e - s for s, e, _, _ in ca_cuda.resident_plan(n + 2 * K, nx, K, grid)[-1]) \
            >= resident_cuda.BAND_ALIGN or grid == 1


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
                                               (2, 65, 1, "K6"), (8, 100, 5, "K7 K=2"),
                                               (13, 128, 13, "K7 K=3"),
                                               (40, 256, 48, "K7 K=8")])
def test_two_copy_walk_computes_each_cell_once(rows, nx, grid, form):
    """Every step computes each of its cells once; K7 (``rows`` body rows,
    depth K) at every step of its shrinking plan."""
    if form.startswith("K7"):
        K = int(form.split("=")[1])
        ext = rows + 2 * K
        plan = ca_cuda.resident_plan(ext, nx, K, grid)
        spans = [(t + 1, ext - t - 1) for t in range(K)]
    else:
        plan = (resident_cuda.grid_plan(rows, nx, grid) if form == "K2"
                else ghosted_cuda.shard_plan(rows, nx, grid))
        spans = [(0, rows)]
    for step, (r0, r1) in zip(plan, spans):
        seen = []
        for entry in step:
            for c, j, i in _walk(entry, nx):
                assert (j, i) == divmod(c, nx)
                seen.append(c)
        assert sorted(seen) == list(range(r0 * nx, r1 * nx))


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


@pytest.mark.parametrize("n,nx,K", [(256, 1024, 8), (8, 100, 2), (13, 128, 3)], ids=str)
def test_k7_partials_layout(n, nx, K):
    """K7's partials buffer (``resident_cuda.partials_buffer`` of its K-step
    plan): grid step counters at zero, each on a 128-byte line of its own,
    then the plan, step after step (K x grid x 4 int32), then K x grid
    sums, where the kernel (two::run with ExtSlab::kPerStep) looks for
    them."""
    ext, grid = n + 2 * K, _k7_grid(n, nx, K)
    plan = ca_cuda.resident_plan(ext, nx, K, grid)
    buf = resident_cuda.partials_buffer(plan, K, "cpu")
    head = resident_cuda.COUNTER_WORDS * grid
    assert buf.numel() == head + 4 * K * grid + K * grid
    words = buf.view(torch.int32)
    assert not words[:head].any() and not words[head + 4 * K * grid:].any()
    assert words[head:head + 4 * K * grid].reshape(K, grid, 4).tolist() == \
        [[list(e) for e in step] for step in plan]


def test_k6_plan_waits_stay_local_on_the_golden_shard():
    """On the 256x1024 shard of the golden grid over 4 at the card's 528
    blocks, a band is about half a row: each block waits for the blocks of
    its rows and the rows next to them, at most 10 of the 528; the first
    and last rows' blocks wait on no block past the ghosts."""
    plan = ghosted_cuda.shard_plan(256, 1024, 528)[0]
    assert max(n for _, _, _, n in plan) <= 10
    assert plan[0][2] == 0 and plan[-1][2] + plan[-1][3] == 528
