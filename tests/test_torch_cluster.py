"""K11, the ensemble's cluster-resident kernel (csrc/cluster.cu), on the CPU.

The kernel runs only on the card (chip_smoke.py phase 3j holds it bitwise
to the plain batched step there).  Here its host side is held:

- ``ensemble_cuda.cluster_plan``: the bands cover every row once, a block's
  shared memory stays within Hopper's 232,448 bytes, C is at most 16, and
  no plan exists where an instance fits no cluster;
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


# The H100's resident clusters of K11 (cudaOccupancyMaxActiveClusters; one
# block of 1024 threads an SM; the same at every shared size measured, 25 KB
# to 209 KB): NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 5).
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def h100_clusters(C: int, smem: int) -> int:
    """The card's cluster query as the H100 answered it."""
    assert smem <= ensemble_cuda.SMEM_MAX
    return H100_CLUSTERS[C]


def only(*sizes):
    """The H100's cluster query with every size but ``sizes`` taken away."""
    return lambda C, smem: h100_clusters(C, smem) if C in sizes else 0


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
    assert plan.smem <= ensemble_cuda.SMEM_MAX == 232448
    assert plan.smem == ensemble_cuda.cluster_smem(max(h for _, h in plan.bands), nx)
    rows = [r0 + j for r0, h in plan.bands for j in range(h)]
    assert rows == list(range(ny))  # every row in exactly one band, in rank order
    assert max(h for _, h in plan.bands) - min(h for _, h in plan.bands) <= 1
    assert plan.waves == -(-B // h100_clusters(plan.C, plan.smem))


def test_cluster_plan_sizes_of_the_reference_shapes():
    """256^2 fits only C = 16 (208,640 bytes a block); 128^2 fits from C = 4
    and takes it for 16 instances (one wave), 8 for 37 (three waves of 15
    clusters beat two of 30 at twice the band); 64^2 x 149 takes C = 2 and
    x 600 one block an instance; 60x100 fits from C = 2; nothing fits a row
    wider than a tile.  The waves follow the card's resident clusters."""
    q = h100_clusters
    plan = ensemble_cuda.cluster_plan(256, 256, 8, q)
    assert (plan.C, plan.smem, plan.resident, plan.waves) == (16, 208640, 7, 2)
    assert plan.us == 2 * (ensemble_cuda.K11_STEP_US + ensemble_cuda.K11_CELL_US * 16 * 256)
    assert ensemble_cuda.cluster_plan(256, 256, 8, only(8)) is None
    plan = ensemble_cuda.cluster_plan(128, 128, 16, q)
    assert (plan.C, plan.resident) == (4, 30)
    plan = ensemble_cuda.cluster_plan(128, 128, 37, q)
    assert (plan.C, plan.waves) == (8, 3)
    assert ensemble_cuda.cluster_plan(128, 128, 1, only(2)) is None
    plan = ensemble_cuda.cluster_plan(64, 64, 149, q)
    assert (plan.C, plan.waves) == (2, 3)
    plan = ensemble_cuda.cluster_plan(64, 64, 600, q)
    assert (plan.C, plan.waves) == (1, 5)
    assert ensemble_cuda.cluster_plan(60, 100, 3, only(1)) is None
    assert ensemble_cuda.cluster_plan(60, 100, 3, only(2)).C == 2
    assert ensemble_cuda.cluster_plan(8, ensemble_cuda.TILE_CELLS + 1, 1, q) is None
    # Without the card's query the plan takes every cluster at once.
    assert ensemble_cuda.cluster_plan(64, 64, 600).waves == 1


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
    """The tile the kernel takes (TILE_CELLS // nx rows: here one tile a
    band) and C = 2 on 60x100, the odd shape of chip_smoke's phase 3j."""
    p, masks, omegas, accels, f0 = _ensemble(60, 100, 3, True)
    tile_rows = ensemble_cuda.TILE_CELLS // 100
    f_e, _ = emulate(f0, masks, p, omegas, accels, 40, 2, tile_rows)
    f_p, _ = ensemble_cuda.run_plain(f0, masks, p, omegas, accels, 40)
    assert torch.equal(f_e, f_p)


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


# K11 and K2-batch in turns, us per instance-step (tools/kernel_times.py
# --ensemble; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5):
# (n, B, K11, K2-batch) on B instances of the n x n box.
MEASURED = [(64, 6, 0.2852, 0.3981), (64, 12, 0.1584, 0.2198), (64, 25, 0.0954, 0.1197),
            (64, 40, 0.0864, 0.0976), (64, 50, 0.0699, 0.0856), (64, 80, 0.0753, 0.0782),
            (64, 100, 0.0603, 0.0728), (64, 149, 0.0684, 0.0809), (64, 500, 0.0477, 0.1110),
            (128, 1, 2.4683, 2.4056), (128, 5, 0.4876, 0.5873), (128, 6, 0.4087, 0.4979),
            (128, 10, 0.3537, 0.4422), (128, 12, 0.2956, 0.3889), (128, 16, 0.3795, 0.3304),
            (128, 16, 0.3803, 0.3334), (128, 24, 0.2525, 0.2837), (128, 37, 0.2818, 0.3056),
            (128, 64, 0.2709, 0.4203), (256, 1, 6.3390, 2.7483), (256, 4, 1.5857, 1.2862),
            (256, 5, 1.2684, 1.2870), (256, 6, 1.0533, 1.1915), (256, 7, 0.9017, 1.1547),
            (256, 7, 0.9253, 1.1623), (256, 8, 1.5548, 1.1259), (256, 16, 1.1719, 1.6645),
            (64, 1, 1.6870, 2.2844), (64, 70, 0.0857, 0.0813), (64, 140, 0.0727, 0.0822),
            (128, 3, 0.7989, 0.8686), (128, 33, 0.3151, 0.2672), (256, 2, 3.1550, 1.6947),
            (256, 9, 1.3873, 1.1753), (256, 12, 1.0468, 1.4529)]


@pytest.mark.parametrize("n,B,k11,k2b", MEASURED, ids=str)
def test_kernel_choice_takes_the_faster_of_the_measured(n, B, k11, k2b):
    """At every shape K11 and K2-batch were timed at in turns, the policy
    (with the H100's cluster counts) takes the one that was faster; without
    the card's query K11 is not considered."""
    want = "K11" if k11 < k2b else "K2-batch"
    assert ensemble_cuda.kernel_choice(n, n, B, 528, h100_clusters) == want
    assert ensemble_cuda.kernel_choice(n, n, B, 528) != "K11"


def test_kernel_choice_with_k11():
    """The models' boundaries between the measured shapes (ensemble_cuda's
    K11_* and K2B_* constants): at 256^2 K2-batch to 4 instances, K11 from
    5 to 7, K2-batch at 8 and 9 (two waves of 7 clusters), K11 from 10; at
    128^2 K2-batch at 1, K11 from 2 to 15, K2-batch from 16 to 19 (clusters
    of 4 in one wave), K11 from 20 to 30, K2-batch from 31 to 34, K11 from
    35; at 64^2 K11 to 66, K2-batch from 67 to 79 (one block an instance in
    one wave) and 133 to 139, K11 between and above; K1-batch where no
    cluster holds an instance and G < 3; K2-batch for a row wider than a
    tile."""
    q = h100_clusters

    def run(n, B):
        return ensemble_cuda.kernel_choice(n, n, B, 528, q)

    assert [run(256, B) for B in (1, 4, 5, 7, 8, 9, 10, 16)] == [
        "K2-batch", "K2-batch", "K11", "K11", "K2-batch", "K2-batch", "K11", "K11"]
    assert [run(128, B) for B in (1, 2, 15, 16, 19, 20, 30, 31, 34, 35)] == [
        "K2-batch", "K11", "K11", "K2-batch", "K2-batch", "K11", "K11", "K2-batch",
        "K2-batch", "K11"]
    assert [run(64, B) for B in (1, 66, 67, 79, 80, 132, 133, 139, 140, 600)] == [
        "K11", "K11", "K2-batch", "K2-batch", "K11", "K11", "K2-batch", "K2-batch", "K11",
        "K11"]
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
