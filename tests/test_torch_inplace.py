"""K3's plain version against lbm_tpu's in-place resident kernel B3
(``resident_pallas.make_run_all(..., inplace=True)``, interpret mode on the
CPU), in f32 and int16 storage, on the same numpy inputs.

Tolerances as in tests/test_torch_step.py:169-189 for f32 (XLA on the CPU
contracts multiply-adds to FMAs, torch does not): fields within atol 5e-8,
tot_u within rtol 1e-6 on the first step, where both sides start from the
same state, and 1e-4 after.  For int16 the 1-ulp f32 noise flips an int16
at a rounding tie: at most one quantization step on under 1% of cells
(tests/test_vmem.py:255-299), held on each step from the same state.  Bitwise equality of
the kernels with this plain version is held on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlattice
from lbm_tpu.ops import resident_pallas
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu_torch.ops import inplace_cuda, quant
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams

torch.set_num_threads(1)
NY, NX = 32, 128


@pytest.fixture(scope="module")
def scene():
    params = LBMParams(nx=NX, ny=NY, max_iters=13, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    jparams = JParams(nx=NX, ny=NY, max_iters=13, reynolds_dim=10,
                      density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((NY, NX), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[12:16, 60:64] = True
    mask[NY - 2, 90] = True  # a wall on the driven row
    rng = np.random.default_rng(11)
    f0 = np.asarray(jlattice.equilibrium_rest(params.density, NY, NX))
    f0 = (f0 * (1 + 0.01 * rng.random((9, NY, NX), dtype=np.float32))).astype(np.float32)
    return params, jparams, mask, f0


def _b3(jparams, mask, state, steps, chunk, storage):
    run = jax.jit(resident_pallas.make_run_all(
        jparams, mask, steps, chunk=chunk, inplace=True, block_rows=8, interpret=True,
        storage=storage))
    f, tot = run(jnp.asarray(state))
    return np.asarray(f), np.asarray(tot)


def test_k3_plain_matches_b3_f32(scene):
    """13 steps in chunks of 5: two full chunks and a remainder chunk."""
    params, jparams, mask, f0 = scene
    f_j, tot_j = _b3(jparams, mask, f0, 13, 5, "f32")
    launches = LAUNCHES["K3"]
    run = inplace_cuda.make_run_all(params, torch.from_numpy(mask), 13, chunk=5)
    f_t, tot_t = run(torch.from_numpy(f0))
    assert LAUNCHES["K3"] == launches  # CPU tensors take the plain version
    assert tot_t.shape == (13,) and f_t.dtype == torch.float32
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=5e-8)
    np.testing.assert_allclose(tot_t.numpy()[:1], tot_j[:1], rtol=1e-6)
    np.testing.assert_allclose(tot_t.numpy(), tot_j, rtol=1e-4)


def test_k3_plain_matches_b3_i16(scene):
    """The int16 form, 4 steps, each one B3 launch from the same (B3) state
    on both sides: free-running, the tie flips compound through the
    quantization (tests/test_torch_quant.py)."""
    params, jparams, mask, f0 = scene
    run_j = jax.jit(resident_pallas.make_run_all(
        jparams, mask, 1, chunk=1, inplace=True, block_rows=8, interpret=True, storage="i16"))
    q_j = jnp.asarray(quant.quantize(torch.from_numpy(f0), params.density).numpy())
    run_t = inplace_cuda.make_run_all(params, torch.from_numpy(mask), 1, storage="i16")
    launches = LAUNCHES["K3-i16"]
    for _ in range(4):
        q_t, tot_t = run_t(torch.from_numpy(np.array(q_j)))
        q_j, tot_j = run_j(q_j)
        assert q_t.dtype == torch.int16 and q_j.dtype == jnp.int16
        d = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
        assert d.max() <= 1, f"max int16 diff {d.max()}"
        assert (d != 0).mean() < 0.01, f"{int((d != 0).sum())} cells differ"
        np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-6)
    assert LAUNCHES["K3-i16"] == launches


def test_k3_budget_and_state_bytes():
    assert inplace_cuda.state_bytes(1024, 1024) == 36 * 2**20
    assert inplace_cuda.state_bytes(1536, 1536, "i16") == 40.5 * 2**20
    assert inplace_cuda.fits_l2(1024, 1024)  # the 1024^2 f32 headline, 36 MiB
    # int16 has its own budget: K3-i16 won in turns to 1024^2 (18 MiB).
    assert inplace_cuda.fits_l2(256, 256, "i16")  # 1.1 MiB
    assert inplace_cuda.fits_l2(512, 512, "i16")  # 4.5 MiB
    assert inplace_cuda.fits_l2(1024, 1024, "i16")
    assert not inplace_cuda.fits_l2(1025, 1024, "i16")
    assert not inplace_cuda.fits_l2(1536, 1536, "i16")  # 40.5 MiB: K1-i16 measured faster
    assert not inplace_cuda.fits_l2(1536, 1536)  # 81 MiB
    assert not inplace_cuda.fits_l2(2048, 2048, "i16")  # 72 MiB


def test_k3_wrapper_on_cpu_validates():
    params = LBMParams(nx=8, ny=6, max_iters=4, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    obst = torch.zeros((6, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown storage"):
        inplace_cuda.make_run_all(params, obst, 4, storage="bf16")
    run = inplace_cuda.make_run_all(params, obst, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        run(torch.empty((9, 6, 8), device="meta"))
    f, tot = inplace_cuda.make_run_all(params, obst, 0)(torch.ones((9, 6, 8)))
    assert tot.shape == (0,) and torch.equal(f, torch.ones((9, 6, 8)))


# --- the band plan of the AA kernels (K3 here, K8 in test_torch_ca.py) --------


def check_band_plan(plan, rows, nx, grid, ny=None):
    """Every step's ranges cover its rows in order, evenly, none empty; and
    every cell within one row of a block's cells (periodic over ny rows, or
    within the previous step's rows) belongs, in the previous step's split
    (K3: the same split), to a block the block waits for.  Owners are found
    by bisection on the ranges, not by the plan's own formula."""
    import bisect

    assert len(plan) == len(rows)
    for t, step in enumerate(plan):
        r0, r1 = rows[t]
        assert len(step) == grid
        assert step[0][0] == r0 * nx and step[-1][1] == r1 * nx
        assert all(step[b][1] == step[b + 1][0] for b in range(grid - 1))
        sizes = [e - s for s, e, _, _ in step]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        if ny is None and t == 0:
            assert all(n == 0 for _, _, _, n in step)  # step 0 reads only its inputs
            continue
        prev = step if ny is not None else plan[t - 1]
        p0, p1 = rows[t] if ny is not None else rows[t - 1]
        starts = [s for s, _, _, _ in prev]

        def owner(x):
            return bisect.bisect_right(starts, x) - 1

        for s, e, lo, n in step:
            assert 1 <= n <= grid and 0 <= lo < grid
            deps = {(lo + d) % grid for d in range(n)}
            for row in range(s // nx - 1, (e - 1) // nx + 2):
                if ny is not None:
                    row %= ny
                elif not p0 <= row < p1:
                    continue
                need = set(range(owner(row * nx), owner(row * nx + nx - 1) + 1))
                assert need <= deps, (t, s, e, row, sorted(need - deps))


@pytest.mark.parametrize("ny,nx,grid", [(1024, 1024, 528), (1024, 1024, 264), (60, 100, 24),
                                        (64, 100, 37), (7, 33, 1), (5, 6, 1), (3, 7, 2),
                                        (2, 5, 3), (48, 40, 8), (9, 1000, 7), (256, 256, 256)],
                         ids=str)
def test_k3_band_plan_edges(ny, nx, grid):
    """K3's plan: one split for every step, periodic in y; its waits cover
    the rows above and below, across the wrap; grids of every size the
    card gives, down to one block, and rows shorter and longer than a
    block's share."""
    plan = inplace_cuda.band_plan([(0, ny)], nx, grid, ny)
    check_band_plan(plan, [(0, ny)], nx, grid, ny)


def test_k3_band_plan_waits_are_local_at_1024():
    """At the main path's 1024^2 on 528 blocks (1985-1986 cells, about two
    rows, each) a block waits for itself and its two neighbours, or three
    where its rows reach a third block (block 0 across the wrap: 527 and
    1)."""
    plan = inplace_cuda.band_plan([(0, 1024)], 1024, 528, 1024)[0]
    assert {n for _, _, _, n in plan} == {3, 4}
    assert plan[0][2:] == (527, 3) and plan[527][2:] == (526, 3)
    with pytest.raises(ValueError, match="cannot be split"):
        inplace_cuda.band_plan([(0, 2)], 3, 7, 2)


def test_aa_partials_layout():
    """The partials buffer of K3 and K8: the plan at its head (int32), then
    one zero step counter per block, then the per-step sums, t x grid + b
    (the fixed order of the |u| pass); its size in words."""
    plan = inplace_cuda.band_plan([(0, 6)], 10, 4, 6)
    assert inplace_cuda.partials_words(1, 4, 256) == 4 * 4 + 4 + 256 * 4
    buf = inplace_cuda.partials_buffer(plan, 256, "cpu")
    assert buf.dtype == torch.float32 and buf.shape == (4 * 4 + 4 + 256 * 4,)
    words = buf.view(torch.int32)
    assert words[:16].tolist() == [v for entry in plan[0] for v in entry]
    assert not words[16:].any()  # counters and sums start at zero
