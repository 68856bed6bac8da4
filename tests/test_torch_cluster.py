"""K11, the ensemble's cluster-resident kernel (csrc/cluster.cu), on the CPU.

The kernel runs only on the card (chip_smoke.py phase 3j holds it bitwise
to the plain batched step there).  Here its host side is held:

- ``ensemble_cuda.cluster_plan``: the bands cover every row once, a block's
  shared memory stays within Hopper's 232,448 bytes (two blocks' within an
  SM's 233,472 wherever it takes blocks of 512 threads), C is at most 16,
  and no plan exists where an instance fits no cluster; at every shape
  where both block shapes were timed pinned, its pick is no slower than
  the 1024-thread plan it replaced;
- the edge map (:func:`edge_map`, the kernel's ``prev`` and ``next``): the
  row below and above each band belong to the right rank's last and first
  row, wrapping;
- the in-place schedule itself, emulated in torch (:func:`emulate`): one
  buffer a band, the rows next to it pushed by the neighbours by step
  parity, holding only the five planes a neighbour reads (the rest NaN),
  tiles of whole rows, carry rows in two buffers; each tile's rows updated
  through ``fused_torch.fused_step_ext`` on exactly the rows the kernel
  reads.  It equals
  ``fused_torch.run_ensemble_plain`` bitwise, and a schedule without the
  carry or with the pushed rows of the wrong parity does not;
- ``kernel_choice`` with K11: the faster kernel at every shape timed in
  turns, and the models' boundaries between them;
- the emulated schedule against ``lbm_tpu``'s ``run_ensemble`` (XLA on the
  CPU contracts multiply-adds into FMAs and torch does not: fields within
  atol 2e-7, av within rtol 1e-4, as tests/test_torch_ensemble.py states).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from lbm_tpu.params import LBMParams as JParams
from lbm_tpu.tools import ensemble as jensemble
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import ensemble_cuda, fused_torch
from lbm_tpu_torch.params import LBMParams, with_driven_row
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)

BELOW = (2, 3, 5, 6, 7)  # planes a row serves as the row below a cell
ABOVE = (3, 4, 6, 7, 8)  # planes a row serves as the row above


# The H100's resident clusters of K11 (cudaOccupancyMaxActiveClusters):
# blocks of 1024 threads, one an SM, the same at every shared size measured
# (25 KB to 209 KB); blocks of 512 threads, two an SM where two blocks'
# shared memory fits it (24,704 to 104,960 B measured), else as 1024
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5).  The program asks
# the card; these stubs answer as it did.
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
H100_CLUSTERS_SHARED = {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}
H100_SM_SMEM = 233472  # shared memory of an SM, bytes (228 KiB)
H100_BLOCK_RESERVE = 1024  # shared memory the card keeps for each resident block


def two_fit_an_sm(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes of dynamic shared memory fit
    one of the H100's SMs."""
    return 2 * (smem + H100_BLOCK_RESERVE) <= H100_SM_SMEM


def h100_clusters(C: int, smem: int, threads: int = 1024) -> int:
    """The card's cluster query as the H100 answered it."""
    assert smem <= ensemble_cuda.SMEM_MAX
    if threads == 512 and two_fit_an_sm(smem):
        return H100_CLUSTERS_SHARED[C]
    return H100_CLUSTERS[C]


def only(*sizes, threads=ensemble_cuda.CLUSTER_THREADS):
    """The H100's cluster query with every size but ``sizes`` and every
    block shape but ``threads`` taken away."""
    return lambda C, smem, t: h100_clusters(C, smem, t) if C in sizes and t in threads else 0


def edge_map(C: int) -> list[tuple[int, int]]:
    """For each rank of a K11 cluster, (prev, next) as csrc/cluster.cu
    takes them: the rank whose last row is the row below the band (row
    r0 - 1, wrapping) and the rank whose first row is the row above it
    (row r0 + h); C = 1 wraps onto itself."""
    return [((r - 1) % C, (r + 1) % C) for r in range(C)]


def _params(ny, nx):
    return LBMParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10, density=0.1, accel=0.005,
                     omega=1.85)


@pytest.mark.parametrize("ny,nx", [(64, 64), (128, 128), (128, 256), (256, 256), (256, 320),
                                   (60, 100), (512, 512), (7, 33)], ids=str)
@pytest.mark.parametrize("B", [1, 8, 149])
def test_cluster_plan_bands_and_capacity(ny, nx, B):
    plan = ensemble_cuda.cluster_plan(ny, nx, B, h100_clusters)
    if (ny, nx) in ((256, 320), (512, 512)):  # no C holds a band within 232,448 bytes
        assert plan is None
        for C in ensemble_cuda.CLUSTER_SIZES:
            assert ensemble_cuda.cluster_smem(-(-ny // C), nx) > ensemble_cuda.SMEM_MAX
        return
    assert plan is not None and plan.C in ensemble_cuda.CLUSTER_SIZES and plan.C <= 16
    assert plan.threads in ensemble_cuda.CLUSTER_THREADS
    assert nx <= ensemble_cuda.CELLS_A_THREAD * plan.threads  # a row fits a tile
    assert plan.smem <= ensemble_cuda.SMEM_MAX == 232448
    assert plan.smem == ensemble_cuda.cluster_smem(max(h for _, h in plan.bands), nx)
    if plan.threads == 512:  # two blocks' shared memory fits the SM
        assert two_fit_an_sm(plan.smem)
    rows = [r0 + j for r0, h in plan.bands for j in range(h)]
    assert rows == list(range(ny))  # every row in exactly one band, in rank order
    assert max(h for _, h in plan.bands) - min(h for _, h in plan.bands) <= 1
    assert plan.waves == -(-B // h100_clusters(plan.C, plan.smem, plan.threads))


def test_cluster_plan_sizes_of_the_reference_shapes():
    """256^2 fits only C = 16 (208,640 bytes a block, one block an SM) and
    keeps 1024 threads; 128^2 x 64, the benchmark's sweep, takes 512
    threads at C = 8 (two blocks of 104,960 bytes an SM: 30 clusters, 3
    waves, not 5), x 16 the same at C = 16, and x 3 1024 threads at C = 16
    (3 clusters of 512 would each have SMs to themselves); 64^2 x 149 takes
    512 threads at C = 4 and x 600 at C = 2 (C = 1's 166,784 bytes fit an
    SM once); 60x100 fits from C = 2; nothing fits a row wider than a tile.
    The waves follow the card's resident clusters of each shape."""
    q = h100_clusters
    m = ensemble_cuda
    plan = m.cluster_plan(256, 256, 8, q)
    assert (plan.threads, plan.C, plan.smem, plan.resident, plan.waves) == (1024, 16, 208640, 7, 2)
    assert plan.us == 2 * (m.K11_STEP_US[1024] + m.K11_CELL_US[1024] * 16 * 256)
    assert m.cluster_plan(256, 256, 8, only(8)) is None
    plan = m.cluster_plan(128, 128, 64, q)
    assert (plan.threads, plan.C, plan.smem, plan.resident, plan.waves) == (512, 8, 104960, 30, 3)
    # Two waves of two bands an SM, and a last of 4 clusters, one an SM.
    assert plan.us == pytest.approx(3 * m.K11_STEP_US[512] + m.K11_CELL_US[512] * 5 * 16 * 128)
    assert plan.label() == "C=8, 512 threads, 3 waves"
    assert m.cluster_plan(128, 128, 64, only(8, threads=(1024,))).waves == 5
    plan = m.cluster_plan(128, 128, 16, q)
    assert (plan.threads, plan.C, plan.resident, plan.waves) == (512, 16, 14, 2)
    plan = m.cluster_plan(128, 128, 3, q)
    assert (plan.threads, plan.C, plan.waves) == (1024, 16, 1)
    assert m.cluster_plan(128, 128, 1, only(2)) is None
    plan = m.cluster_plan(64, 64, 149, q)
    assert (plan.threads, plan.C, plan.waves) == (512, 4, 3)
    plan = m.cluster_plan(64, 64, 600, q)
    assert (plan.threads, plan.C, plan.waves) == (512, 2, 5)
    assert m.cluster_plan(64, 64, 600, only(1, 2, threads=(1024,))).C == 1
    assert m.cluster_plan(60, 100, 3, only(1)) is None
    assert m.cluster_plan(60, 100, 3, only(2)).C == 2
    assert m.cluster_plan(8, 2049, 1, q) is None
    # Without the card's query the plan takes every cluster at once, one
    # block an SM.
    plan = m.cluster_plan(64, 64, 600)
    assert (plan.waves, plan.threads) == (1, 1024)


@pytest.mark.parametrize("n,B", [(256, 8), (64, 600), (64, 500), (256, 16), (256, 1)], ids=str)
def test_cluster_plan_keeps_1024_threads_where_two_blocks_do_not_fit(n, B):
    """Where no block of 512 threads can share an SM (256^2: C = 16 alone
    fits, 208,640 bytes a block), or shares none in its first wave, the
    plan keeps 1024 threads; 64^2 x 500 and x 600 fit two blocks of C = 2
    an SM, and take them."""
    plan = ensemble_cuda.cluster_plan(n, n, B, h100_clusters)
    want = 512 if n == 64 else 1024
    assert plan.threads == want
    if want == 512:
        assert two_fit_an_sm(plan.smem)
        assert min(B, plan.resident) > H100_CLUSTERS[plan.C]


class _CountingLib:
    """A kernel library whose cluster query answers as the H100 did and
    counts what it is asked; -1 for C = 3, a size the card refuses."""

    def __init__(self):
        self.asked = Counter()

    def lbm_cluster_batch_max_clusters(self, C, smem, threads, device):
        self.asked[C, smem, threads, device] += 1
        return -1 if C == 3 else h100_clusters(C, smem, threads)


@pytest.mark.parametrize("device", [0, 1])
def test_card_clusters_asks_the_card_once_a_process(device):
    """Every plan of a process, on one library and device, shares one set of
    answers: the second study's plan asks the card nothing, and each (C,
    shared size, threads) was asked once; another device asks afresh; a
    refused query raises."""
    lib = _CountingLib()
    q = ensemble_cuda.card_clusters(lib, device)
    first = ensemble_cuda.cluster_plan(128, 128, 64, q)
    asked = sum(lib.asked.values())
    assert asked > 0 and set(lib.asked.values()) == {1}
    again = ensemble_cuda.card_clusters(lib, device)
    assert again is q
    assert ensemble_cuda.cluster_plan(128, 128, 64, again) == first
    assert sum(lib.asked.values()) == asked
    assert (first.threads, first.C, first.waves) == (512, 8, 3)
    ensemble_cuda.card_clusters(lib, device + 2)(8, first.smem, 512)
    assert lib.asked[8, first.smem, 512, device + 2] == 1
    with pytest.raises(RuntimeError, match="refused the occupancy query"):
        q(3, first.smem, 512)


@pytest.mark.parametrize("ny,C", [(64, 1), (17, 1), (60, 2), (35, 4), (128, 8), (256, 16),
                                  (35, 16), (16, 16)], ids=str)
def test_edge_map_rows_below_and_above_each_band(ny, C):
    bands = ensemble_cuda.cluster_bands(ny, C)
    for r, (prev, nxt) in enumerate(edge_map(C)):
        r0, h = bands[r]
        p0, ph = bands[prev]
        n0, _ = bands[nxt]
        assert p0 + ph - 1 == (r0 - 1) % ny  # prev's last row: the row below the band
        assert n0 == (r0 + h) % ny  # next's first row: the row above it
        if C == 1:
            assert (prev, nxt) == (0, 0)


def _nan_but(row: torch.Tensor, planes) -> torch.Tensor:
    """A (9, nx) row holding only ``planes`` of ``row``, NaN elsewhere."""
    out = torch.full_like(row, float("nan"))
    out[list(planes)] = row[list(planes)]
    return out


def emulate(f0_b, obstacles, params, omegas, accels, steps, C, tile_rows, mutate=None):
    """K11's schedule on the CPU: (f_b, tot (steps, B)).  Each rank keeps
    its band as one (h, 9, nx) buffer updated in place, and by parity the
    row below the band and the row above it, which its neighbours push (the
    planes a neighbour reads, NaN elsewhere): after the load into parity 0,
    then at step t into parity (t + 1) % 2 as each writes its first and
    last rows.  Between barriers the ranks run one after another (the
    kernel runs them at once; the parities keep their rows apart).  A rank
    walks its band in tiles of ``tile_rows`` rows, each tile's rows updated
    from the row below (the pushed row for the first tile, else the carry
    of the last tile's last old row), its own rows and the row above (the
    next band row, or the pushed row for the last tile).  ``mutate``:
    ``"carry"`` reads the row below a tile from the band (already updated),
    ``"parity"`` the pushed rows of the other parity."""
    B, _, ny, nx = f0_b.shape
    bands = ensemble_cuda.cluster_bands(ny, C)
    ranks = edge_map(C)
    f_b = torch.empty_like(f0_b)
    tot = torch.zeros((steps, B), dtype=torch.float32)
    nan_row = torch.full((9, nx), float("nan"))
    for b in range(B):
        pb = params.replace(omega=float(omegas[b]), accel=float(accels[b]))
        ob = obstacles[b] if obstacles.dim() == 3 else obstacles
        band = [f0_b[b, :, r0:r0 + h].permute(1, 0, 2).clone() for r0, h in bands]
        below = [[nan_row, nan_row] for _ in range(C)]  # [rank][parity]
        above = [[nan_row, nan_row] for _ in range(C)]

        def push(r, par):
            prev, nxt = ranks[r]
            above[prev][par] = _nan_but(band[r][0], ABOVE)
            below[nxt][par] = _nan_but(band[r][-1], BELOW)

        for r in range(C):
            push(r, 0)
        for t in range(steps):
            par = t % 2
            read = 1 - par if mutate == "parity" else par
            sums = []
            for r, (r0, h) in enumerate(bands):
                carry = [nan_row, nan_row]
                for k, a in enumerate(range(0, h, tile_rows)):
                    rows = min(tile_rows, h - a)
                    if a == 0:
                        lo = below[r][read]
                    elif mutate == "carry":
                        lo = band[r][a - 1]
                    else:
                        lo = carry[k % 2]
                    hi = above[r][read] if a + rows == h else band[r][a + rows]
                    if a + rows < h:
                        carry[(k + 1) % 2] = _nan_but(band[r][a + rows - 1], BELOW)
                    window = torch.cat([lo[None], band[r][a:a + rows], hi[None]])
                    wrows = [(r0 + a - 1 + e) % ny for e in range(rows + 2)]
                    out = fused_torch.fused_step_ext(window.permute(1, 0, 2), ob[wrows], pb,
                                                     r0 + a - 1, ny, (1, rows + 1))
                    band[r][a:a + rows] = out.f[:, 1:rows + 1].permute(1, 0, 2)
                    sums.append(out.tot_u)
                push(r, 1 - par)
            tot[t, b] = torch.stack(sums).sum()
        f_b[b] = torch.cat(band).permute(1, 0, 2)
    return f_b, tot


def _ensemble(ny, nx, B, geometry, seed=7):
    """(params, masks, omegas, accels, f0_b): walls on the first and last
    columns and an interior block, rows 0 and ny - 1 open, so the flow
    crosses the periodic wrap between the last band and the first (a
    closed box would pass only wall rows across it); a geometry batch adds
    scenegen's cylinder and random walls; accels 0.005, 1.0 (the driven
    row's guard split between columns) and 0.002; a seeded 10%
    perturbation of rest."""
    p = _params(ny, nx)
    m = np.zeros((ny, nx), dtype=bool)
    m[:, 0] = m[:, -1] = True
    m[ny // 3: ny // 3 + 2, nx // 4: nx // 4 + 2] = True
    masks = np.stack([m] * B)
    rng = np.random.default_rng(seed)
    if geometry:
        masks[1] = scenegen.make_mask("cylinder", ny, nx)
        masks[2] = m | (rng.random((ny, nx)) < 0.1)
    omegas = np.linspace(0.6, 1.95, B, dtype=np.float32)
    accels = np.asarray([(0.005, 1.0, 0.002)[b % 3] for b in range(B)], dtype=np.float32)
    rest = lattice.equilibrium_rest(p.density, ny, nx)
    f0 = np.stack([rest * (np.float32(1.0) + rng.uniform(-0.1, 0.1, rest.shape).astype(
        np.float32)) for _ in range(B)])
    return p, torch.from_numpy(masks), omegas, accels, torch.from_numpy(f0)


def _driven_rows(ny, C):
    """The driven row on a band's first row, a band's last row, row 0 and
    row ny - 1 (C = 1, whose band is every row: rows 3 and ny - 3)."""
    bands = ensemble_cuda.cluster_bands(ny, C)
    r0, h = bands[min(1, C - 1)]
    return {"band-first": r0 if C > 1 else 3, "band-last": bands[0][1] - 1 if C > 1 else ny - 3,
            "row-0": 0, "row-last": ny - 1}


# (ny, nx, C, tile rows): carries at every tile size, C = 1's wrap onto
# itself, bands of one and two rows at C = 16, uneven bands.
SCHEDULES = [(24, 20, 4, 2), (17, 12, 1, 3), (35, 9, 16, 1), (30, 14, 8, 4)]


@pytest.mark.parametrize("where", ["band-first", "band-last", "row-0", "row-last"])
@pytest.mark.parametrize("geometry", [False, True], ids=["shared-mask", "geometry"])
@pytest.mark.parametrize("ny,nx,C,tile_rows", SCHEDULES, ids=str)
def test_schedule_is_bitwise_the_plain_batched_step(ny, nx, C, tile_rows, geometry, where):
    p, masks, omegas, accels, f0 = _ensemble(ny, nx, 3, geometry)
    p = with_driven_row(p, _driven_rows(ny, C)[where])
    obst = masks if geometry else masks[0]
    steps = 40
    f_e, tot_e = emulate(f0, obst, p, omegas, accels, steps, C, tile_rows)
    f_p, tot_p = ensemble_cuda.run_plain(f0, obst, p, omegas, accels, steps)
    assert bool(torch.isfinite(f_p).all())
    assert torch.equal(f_e, f_p), float((f_e - f_p).abs().max())
    # |u| grouped by band and tile, not by the plain step's order.
    torch.testing.assert_close(tot_e, tot_p, rtol=1e-5, atol=0.0)


def test_schedule_at_the_kernels_tile_size():
    """The tile the 1024-thread form takes (2048 // nx rows: here one tile
    a band) and C = 2 on 60x100, the odd shape of chip_smoke's phase 3j."""
    p, masks, omegas, accels, f0 = _ensemble(60, 100, 3, True)
    tile_rows = ensemble_cuda.CELLS_A_THREAD * 1024 // 100
    f_e, _ = emulate(f0, masks, p, omegas, accels, 40, 2, tile_rows)
    f_p, _ = ensemble_cuda.run_plain(f0, masks, p, omegas, accels, 40)
    assert torch.equal(f_e, f_p)


@pytest.mark.parametrize("ny,nx,C,steps", [(60, 100, 2, 40), (128, 128, 8, 24)], ids=str)
def test_schedule_at_the_co_resident_tile_size(ny, nx, C, steps):
    """The tile of the 512-thread form (1024 // nx rows): 60x100 at C = 2
    (three tiles a band of 30 rows, the last of 6) and 128^2 at C = 8, the
    benchmark's sweep, where a band of 16 rows is two tiles of 8, so every
    band's second tile reads its row below from the carry (without it the
    fields differ)."""
    p, masks, omegas, accels, f0 = _ensemble(ny, nx, 3, False)
    p = with_driven_row(p, _driven_rows(ny, C)["band-first"])
    tile_rows = ensemble_cuda.CELLS_A_THREAD * 512 // nx
    assert max(h for _, h in ensemble_cuda.cluster_bands(ny, C)) > tile_rows
    f_e, tot_e = emulate(f0, masks[0], p, omegas, accels, steps, C, tile_rows)
    f_p, tot_p = ensemble_cuda.run_plain(f0, masks[0], p, omegas, accels, steps)
    assert torch.equal(f_e, f_p)
    torch.testing.assert_close(tot_e, tot_p, rtol=1e-5, atol=0.0)
    f_m, _ = emulate(f0, masks[0], p, omegas, accels, steps, C, tile_rows, "carry")
    assert not torch.equal(f_m, f_p)


@pytest.mark.parametrize("mutate", ["carry", "parity"])
@pytest.mark.parametrize("ny,nx,C,tile_rows", SCHEDULES[:3], ids=str)
def test_schedule_mutations_fail(ny, nx, C, tile_rows, mutate):
    """Dropping the carry (the row below a tile read from the band, already
    updated), or reading the pushed rows of the other parity, breaks
    bitwise equality: the emulation holds the kernel to both hazards."""
    p, masks, omegas, accels, f0 = _ensemble(ny, nx, 3, False)
    if mutate == "carry" and tile_rows >= max(h for _, h in ensemble_cuda.cluster_bands(ny, C)):
        pytest.fail("the case needs two tiles a band to reach the carry")
    f_e, _ = emulate(f0, masks[0], p, omegas, accels, 40, C, tile_rows, mutate)
    f_p, _ = ensemble_cuda.run_plain(f0, masks[0], p, omegas, accels, 40)
    assert not torch.equal(f_e, f_p)


# K11 pinned to each block shape and cluster size, and K2-batch, in turns,
# us per instance-step (tools/kernel_times.py --cluster-forms, two calls:
# the 34 shapes, then 64^2 x 67-69 and 128^2 x 17, 18 and 20 around the
# refitted models' boundaries; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 5), on B instances of the n x n box:
# (n, B) -> ({(threads, C): K11}, K2-batch; None where its groups cannot
# all be resident).
FORMS = {
    (64, 1): ({(1024, 1): 5.9053, (1024, 2): 3.3945, (1024, 4): 2.3382, (1024, 8): 1.8744, (1024, 16): 1.7381, (512, 1): 7.2155, (512, 2): 3.9911, (512, 4): 2.4270, (512, 8): 1.7852, (512, 16): 1.6294}, 2.4546),
    (64, 6): ({(1024, 1): 0.9914, (1024, 2): 0.5748, (1024, 4): 0.3909, (1024, 8): 0.3108, (1024, 16): 0.2835, (512, 1): 1.2110, (512, 2): 0.6753, (512, 4): 0.4047, (512, 8): 0.3011, (512, 16): 0.2645}, 0.4137),
    (64, 12): ({(1024, 1): 0.4961, (1024, 2): 0.2869, (1024, 4): 0.1976, (1024, 8): 0.1581, (1024, 16): 0.2791, (512, 1): 0.6050, (512, 2): 0.3377, (512, 4): 0.2043, (512, 8): 0.1520, (512, 16): 0.1509}, 0.2239),
    (64, 25): ({(1024, 1): 0.2388, (1024, 2): 0.1380, (1024, 4): 0.0948, (1024, 8): 0.1487, (1024, 16): 0.2664, (512, 1): 0.2913, (512, 2): 0.1628, (512, 4): 0.0984, (512, 8): 0.0876, (512, 16): 0.1386}, 0.1238),
    (64, 40): ({(1024, 1): 0.1485, (1024, 2): 0.0859, (1024, 4): 0.1154, (1024, 8): 0.1384, (1024, 16): 0.2487, (512, 1): 0.1818, (512, 2): 0.1011, (512, 4): 0.0832, (512, 8): 0.0983, (512, 16): 0.1300}, 0.0980),
    (64, 50): ({(1024, 1): 0.1194, (1024, 2): 0.0692, (1024, 4): 0.0935, (1024, 8): 0.1472, (1024, 16): 0.2627, (512, 1): 0.1460, (512, 2): 0.0815, (512, 4): 0.0678, (512, 8): 0.0866, (512, 16): 0.1375}, 0.0883),
    (64, 67): ({(1024, 1): 0.0888, (1024, 2): 0.0995, (1024, 4): 0.1026, (1024, 8): 0.1367, (1024, 16): 0.2443, (512, 1): 0.1083, (512, 2): 0.0883, (512, 4): 0.0803, (512, 8): 0.0881, (512, 16): 0.1276}, 0.0861),
    (64, 68): ({(1024, 1): 0.0872, (1024, 2): 0.0979, (1024, 4): 0.1011, (1024, 8): 0.1348, (1024, 16): 0.2427, (512, 1): 0.1066, (512, 2): 0.0866, (512, 4): 0.0790, (512, 8): 0.0867, (512, 16): 0.1255}, 0.0846),
    (64, 69): ({(1024, 1): 0.0859, (1024, 2): 0.0966, (1024, 4): 0.0998, (1024, 8): 0.1330, (1024, 16): 0.2394, (512, 1): 0.1050, (512, 2): 0.0856, (512, 4): 0.0779, (512, 8): 0.0865, (512, 16): 0.1246}, 0.0839),
    (64, 70): ({(1024, 1): 0.0852, (1024, 2): 0.0958, (1024, 4): 0.0989, (1024, 8): 0.1319, (1024, 16): 0.2414, (512, 1): 0.1041, (512, 2): 0.0849, (512, 4): 0.0772, (512, 8): 0.0859, (512, 16): 0.1252}, 0.0827),
    (64, 80): ({(1024, 1): 0.0746, (1024, 2): 0.0843, (1024, 4): 0.0873, (1024, 8): 0.1375, (1024, 16): 0.2472, (512, 1): 0.0910, (512, 2): 0.0743, (512, 4): 0.0681, (512, 8): 0.0811, (512, 16): 0.1287}, 0.0795),
    (64, 100): ({(1024, 1): 0.0598, (1024, 2): 0.0678, (1024, 4): 0.0923, (1024, 8): 0.1294, (1024, 16): 0.2468, (512, 1): 0.0731, (512, 2): 0.0596, (512, 4): 0.0658, (512, 8): 0.0806, (512, 16): 0.1338}, 0.0739),
    (64, 140): ({(1024, 1): 0.0836, (1024, 2): 0.0719, (1024, 4): 0.0830, (1024, 8): 0.1310, (1024, 16): 0.2415, (512, 1): 0.1029, (512, 2): 0.0667, (512, 4): 0.0608, (512, 8): 0.0770, (512, 16): 0.1251}, 0.0831),
    (64, 149): ({(1024, 1): 0.0789, (1024, 2): 0.0680, (1024, 4): 0.0789, (1024, 8): 0.1252, (1024, 16): 0.2431, (512, 1): 0.0970, (512, 2): 0.0629, (512, 4): 0.0574, (512, 8): 0.0740, (512, 16): 0.1266}, 0.0822),
    (64, 500): ({(1024, 1): 0.0475, (1024, 2): 0.0544, (1024, 4): 0.0791, (1024, 8): 0.1249, (1024, 16): 0.2390, (512, 1): 0.0585, (512, 2): 0.0462, (512, 4): 0.0543, (512, 8): 0.0726, (512, 16): 0.1237}, 0.1090),
    (64, 600): ({(1024, 1): 0.0494, (1024, 2): 0.0561, (1024, 4): 0.0785, (1024, 8): 0.1243, (1024, 16): 0.2388, (512, 1): 0.0607, (512, 2): 0.0477, (512, 4): 0.0533, (512, 8): 0.0727, (512, 16): 0.1236}, None),
    (128, 1): ({(1024, 4): 5.9822, (1024, 8): 3.4906, (1024, 16): 2.4226, (512, 4): 7.2858, (512, 8): 4.1400, (512, 16): 2.5278}, 2.3815),
    (128, 3): ({(1024, 4): 1.9996, (1024, 8): 1.1631, (1024, 16): 0.7990, (512, 4): 2.4346, (512, 8): 1.3801, (512, 16): 0.8313}, 0.9159),
    (128, 5): ({(1024, 4): 1.2070, (1024, 8): 0.7076, (1024, 16): 0.4862, (512, 4): 1.4706, (512, 8): 0.8395, (512, 16): 0.5102}, 0.6071),
    (128, 6): ({(1024, 4): 1.0056, (1024, 8): 0.5887, (1024, 16): 0.4036, (512, 4): 1.2242, (512, 8): 0.6933, (512, 16): 0.4201}, 0.5198),
    (128, 10): ({(1024, 4): 0.6032, (1024, 8): 0.3529, (1024, 16): 0.4708, (512, 4): 0.7332, (512, 8): 0.4179, (512, 16): 0.3403}, 0.4537),
    (128, 12): ({(1024, 4): 0.5037, (1024, 8): 0.2949, (1024, 16): 0.3946, (512, 4): 0.6123, (512, 8): 0.3501, (512, 16): 0.2838}, 0.3992),
    (128, 16): ({(1024, 4): 0.3784, (1024, 8): 0.4277, (1024, 16): 0.4400, (512, 4): 0.4604, (512, 8): 0.3740, (512, 16): 0.3451}, 0.3381),
    (128, 17): ({(1024, 4): 0.3524, (1024, 8): 0.4004, (1024, 16): 0.4116, (512, 4): 0.4284, (512, 8): 0.3495, (512, 16): 0.3226}, 0.3415),
    (128, 18): ({(1024, 4): 0.3335, (1024, 8): 0.3799, (1024, 16): 0.3895, (512, 4): 0.4059, (512, 8): 0.3310, (512, 16): 0.3052}, 0.3346),
    (128, 20): ({(1024, 4): 0.3004, (1024, 8): 0.3431, (1024, 16): 0.3523, (512, 4): 0.3653, (512, 8): 0.2987, (512, 16): 0.2761}, 0.3212),
    (128, 24): ({(1024, 4): 0.2525, (1024, 8): 0.2895, (1024, 16): 0.3917, (512, 4): 0.3071, (512, 8): 0.2508, (512, 16): 0.2793}, 0.2917),
    (128, 33): ({(1024, 4): 0.3571, (1024, 8): 0.3130, (1024, 16): 0.3577, (512, 4): 0.4387, (512, 8): 0.2876, (512, 16): 0.2626}, 0.2762),
    (128, 37): ({(1024, 4): 0.3206, (1024, 8): 0.2807, (1024, 16): 0.3799, (512, 4): 0.3926, (512, 8): 0.2574, (512, 16): 0.2697}, 0.3088),
    (128, 64): ({(1024, 4): 0.2784, (1024, 8): 0.2698, (1024, 16): 0.3659, (512, 4): 0.3405, (512, 8): 0.2359, (512, 16): 0.2563}, 0.4163),
    (256, 1): ({(1024, 16): 6.3012, (512, 16): 7.7623}, 2.8689),
    (256, 2): ({(1024, 16): 3.1505, (512, 16): 3.8822}, 1.7648),
    (256, 4): ({(1024, 16): 1.5712, (512, 16): 1.9355}, 1.3162),
    (256, 5): ({(1024, 16): 1.2586, (512, 16): 1.5528}, 1.3197),
    (256, 6): ({(1024, 16): 1.0416, (512, 16): 1.2855}, 1.2181),
    (256, 7): ({(1024, 16): 0.8932, (512, 16): 1.1061}, 1.1843),
    (256, 8): ({(1024, 16): 1.5216, (512, 16): 1.8688}, 1.1647),
    (256, 9): ({(1024, 16): 1.3561, (512, 16): 1.6682}, 1.2205),
    (256, 12): ({(1024, 16): 1.0275, (512, 16): 1.2636}, 1.4741),
    (256, 16): ({(1024, 16): 1.1497, (512, 16): 1.4139}, 1.6446),
}
# Shapes held out of the fit: timed the same way after the models were
# fitted to FORMS, and never used to choose them (the same card).
HELD_OUT = {
    (64, 200): ({(1024, 1): 0.0589, (1024, 2): 0.0669, (1024, 4): 0.0811, (1024, 8): 0.1279, (1024, 16): 0.2391, (512, 1): 0.0724, (512, 2): 0.0582, (512, 4): 0.0578, (512, 8): 0.0750, (512, 16): 0.1267}, 0.1052),
    (64, 300): ({(1024, 1): 0.0591, (1024, 2): 0.0566, (1024, 4): 0.0783, (1024, 8): 0.1248, (1024, 16): 0.2400, (512, 1): 0.0728, (512, 2): 0.0497, (512, 4): 0.0541, (512, 8): 0.0740, (512, 16): 0.1250}, 0.1109),
    (128, 48): ({(1024, 4): 0.2477, (1024, 8): 0.2861, (1024, 16): 0.3443, (512, 4): 0.3027, (512, 8): 0.2506, (512, 16): 0.2463}, 0.3766),
    (128, 100): ({(1024, 4): 0.2379, (1024, 8): 0.2423, (1024, 16): 0.3503, (512, 4): 0.2912, (512, 8): 0.2084, (512, 16): 0.2454}, 0.4323),
    (256, 24): ({(1024, 16): 1.0147, (512, 16): 1.2509}, 1.7033),
}
# The plan K11 took before its blocks of 512 threads: 1024 threads, C by
# waves x (0.91 us + 1.27 ns x a block's band cells).
SHIPPED_STEP_US, SHIPPED_CELL_US = 0.91, 1.27e-3


def shipped_c(n: int, B: int) -> int:
    best = None
    for C in ensemble_cuda.CLUSTER_SIZES:
        hmax = -(-n // C)
        if C > n or ensemble_cuda.cluster_smem(hmax, n) > ensemble_cuda.SMEM_MAX:
            continue
        us = -(-B // H100_CLUSTERS[C]) * (SHIPPED_STEP_US + SHIPPED_CELL_US * hmax * n)
        if best is None or us < best[0]:
            best = (us, C)
    return best[1]


@pytest.mark.parametrize("n,B", sorted(FORMS), ids=str)
def test_cluster_plan_no_slower_than_the_shipped(n, B):
    """At every shape timed pinned, the form the plan takes was no slower
    than the 1024-thread form the plan took before, within 2%; at 128^2 x
    64 (the benchmark's sweep) it is the fastest of all, 12% under."""
    forms, _ = FORMS[n, B]
    plan = ensemble_cuda.cluster_plan(n, n, B, h100_clusters)
    took, shipped = forms[plan.threads, plan.C], forms[1024, shipped_c(n, B)]
    assert took <= 1.02 * shipped, (plan.label(), took, shipped)
    if (n, B) == (128, 64):
        assert took == min(forms.values()) < 0.9 * shipped


@pytest.mark.parametrize("n,B", sorted(HELD_OUT), ids=str)
def test_cluster_plan_at_shapes_held_out_of_the_fit(n, B):
    """At shapes the models were not fitted to, the plan's form was within
    2% of the fastest form timed, no slower than the 1024-thread plan of
    before within 2%, and the policy took the faster kernel."""
    forms, k2b = HELD_OUT[n, B]
    plan = ensemble_cuda.cluster_plan(n, n, B, h100_clusters)
    took = forms[plan.threads, plan.C]
    assert took <= 1.02 * min(forms.values()), (plan.label(), took, min(forms.values()))
    assert took <= 1.02 * forms[1024, shipped_c(n, B)]
    want = "K11" if took < k2b else "K2-batch"
    assert ensemble_cuda.kernel_choice(n, n, B, 528, h100_clusters) == want


@pytest.mark.parametrize("n,B", sorted(k for k, v in FORMS.items() if v[1] is not None),
                         ids=str)
def test_kernel_choice_takes_the_faster_of_the_measured(n, B):
    """At every shape K11 and K2-batch were timed at in turns, the policy
    (with the H100's cluster counts) takes the one that was faster, K11 in
    the form its plan takes; without the card's query K11 is not
    considered."""
    forms, k2b = FORMS[n, B]
    plan = ensemble_cuda.cluster_plan(n, n, B, h100_clusters)
    want = "K11" if forms[plan.threads, plan.C] < k2b else "K2-batch"
    assert ensemble_cuda.kernel_choice(n, n, B, 528, h100_clusters) == want
    assert ensemble_cuda.kernel_choice(n, n, B, 528) != "K11"


def test_kernel_choice_with_k11():
    """The models' boundaries between the measured shapes (ensemble_cuda's
    K11_* and K2B_* constants): at 256^2 K2-batch to 4 instances, K11 from
    5 to 7, K2-batch at 8 and 9 (two waves of 7 clusters), K11 from 10; at
    128^2 K2-batch at 1, K11 from 2 to 15, K2-batch at 16 (one wave of 30
    clusters of 8, two blocks of 512 threads on 8 SMs only), K11 from 17;
    at 64^2 K11 at every size (K2-batch took 67-79 and 133-139 before the
    512-thread blocks); K1-batch where no cluster holds an instance and
    G < 3; K2-batch for a row wider than a tile."""
    q = h100_clusters

    def run(n, B):
        return ensemble_cuda.kernel_choice(n, n, B, 528, q)

    assert [run(256, B) for B in (1, 4, 5, 7, 8, 9, 10, 16)] == [
        "K2-batch", "K2-batch", "K11", "K11", "K2-batch", "K2-batch", "K11", "K11"]
    assert [run(128, B) for B in (1, 2, 15, 16, 17, 18, 30, 33, 35, 64)] == [
        "K2-batch", "K11", "K11", "K2-batch", "K11", "K11", "K11", "K11", "K11", "K11"]
    assert {run(64, B) for B in range(1, 701)} == {"K11"}
    assert ensemble_cuda.kernel_choice(512, 512, 8, 528, q) == "K2-batch"  # fits no cluster
    assert ensemble_cuda.kernel_choice(512, 512, 200, 528, q) == "K1-batch"  # G = 2
    assert ensemble_cuda.kernel_choice(8, 4096, 64, 528, q) == "K2-batch"  # wider than a tile


def test_k2_batch_model_regimes():
    """K2-batch's modelled step: the latency regime (fixed part + a part per
    instance-cell) on few instances, the tier's rate on many, L2 up to the
    two-copy budget and HBM beyond it."""
    m = ensemble_cuda
    assert m.k2_batch_us(128, 128, 3) == m.K2B_STEP_US + 3 * 128 * 128 * m.K2B_CELL_US
    assert m.k2_batch_us(128, 128, 37) == 37 * 128 * 128 * m.K2B_L2_CELL_US
    assert m.k2_batch_us(128, 128, 64) == 64 * 128 * 128 * m.K2B_HBM_CELL_US


def _jparams(p):
    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                   density=p.density, accel=p.accel, omega=p.omega)


@pytest.mark.parametrize("geometry", [False, True], ids=["shared-mask", "geometry"])
def test_schedule_matches_lbm_tpu_ensemble(geometry):
    """K11's schedule (C = 4, tiles of 3 rows) from rest against
    lbm_tpu.tools.ensemble.run_ensemble on the same seeded masks and
    parameters."""
    ny, nx, steps = 24, 20, 30
    p, masks, omegas, _, _ = _ensemble(ny, nx, 3, geometry)
    accels = np.asarray([0.005, 0.01, 0.002], dtype=np.float32)
    obst = masks if geometry else masks[0]
    rest = torch.from_numpy(lattice.equilibrium_rest(p.density, ny, nx))
    f0 = rest.unsqueeze(0).expand(3, -1, -1, -1).contiguous()
    f_e, tot_e = emulate(f0, obst, p, omegas, accels, steps, 4, 3)
    ref = jensemble.run_ensemble(_jparams(p), obst.numpy(), omegas, accels, num_steps=steps)
    np.testing.assert_allclose(f_e.numpy(), ref.f, rtol=0, atol=2e-7)
    fluid = (~obst).reshape(-1, ny * nx).sum(dim=1).numpy().astype(np.float32)
    np.testing.assert_allclose(tot_e.numpy() / fluid, ref.av_vels, rtol=1e-4)
