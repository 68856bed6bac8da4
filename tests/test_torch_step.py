"""lbm_tpu_torch's plain step (the twin) and its kernels' plain versions
against lbm_tpu's jnp step, its Pallas kernels (interpret mode on the CPU)
and the numpy oracle, on the same numpy inputs.

Tolerances: XLA on the CPU contracts multiply-adds into FMAs
(tests/test_pallas.py:77-80) and torch does not, so fields agree to 1 ulp
after one step (atol 5e-8) and drift to atol 2e-7 over 200 steps; the |u|
sums agree within rtol 1e-4 then.  Against the oracle (C expression order,
unpaired equilibria) the bounds are those of tests/test_golden.py:155-156.
Bitwise equality is held on the card, kernel against plain version
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlattice
from lbm_tpu.ops import fused_jnp, fused_pallas, resident_pallas
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu_torch.core import lattice, oracle
from lbm_tpu_torch.ops import fused_cuda, fused_torch, resident_cuda
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams

torch.set_num_threads(1)


def _box(ny, nx, block=None):
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    if block is not None:
        (y0, y1), (x0, x1) = block
        mask[y0:y1, x0:x1] = True
    return mask


def _params(ny, nx, accel=0.005):
    return LBMParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10,
                     density=0.1, accel=accel, omega=1.85)


def _jparams(p):
    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                   density=p.density, accel=p.accel, omega=p.omega)


SCENES = {
    # the small_obstacles fixture of tests/conftest.py
    "16x16-fixture": (16, 16, ((5, 7), (8, 10))),
    "32x64-block": (32, 64, ((10, 14), (20, 26))),
    # not a multiple of 128; interior block touching the driven row's neighbour
    "60x100": (60, 100, ((40, 57), (30, 37))),
}


def _scene(name):
    ny, nx, block = SCENES[name]
    return _params(ny, nx), _box(ny, nx, block)


def _run_jnp(params, mask, steps, f0=None):
    step = fused_jnp.make_single_step(_jparams(params), mask)
    f = jnp.asarray(jlattice.equilibrium_rest(params.density, params.ny, params.nx)
                    if f0 is None else f0)
    tots = []
    for _ in range(steps):
        f, tu = step(f)
        tots.append(tu)
    return np.asarray(f), np.asarray(jnp.stack(tots), dtype=np.float32)


def _run_twin(params, mask, steps, f0=None):
    f = torch.from_numpy(lattice.equilibrium_rest(params.density, params.ny, params.nx)
                         if f0 is None else f0.copy())
    f, tots = fused_torch.run_steps(f, torch.from_numpy(mask), params, steps)
    return f.numpy(), tots.numpy()


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("steps", [1, 200])
def test_twin_matches_fused_jnp(name, steps):
    params, mask = _scene(name)
    f_t, tot_t = _run_twin(params, mask, steps)
    f_j, tot_j = _run_jnp(params, mask, steps)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=5e-8 if steps == 1 else 2e-7)
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-6 if steps == 1 else 1e-4)


def test_twin_driven_row_neighbours_mixed_guard():
    """A random state where the injection guard is false at some driven-row
    cells: the rows next to the driven row pull injected values, so they are
    where a wrong guard shows."""
    params, mask = _scene("32x64-block")
    rng = np.random.default_rng(7)
    f0 = rng.uniform(0.005, 0.02, size=(9, params.ny, params.nx)).astype(np.float32)
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    row = params.accel_row
    f0[3, row, ::3] = w1 * np.float32(0.5)  # guard false at every third cell
    f0[6, row, 1::5] = w2
    mask[row, 40] = True  # a wall on the driven row
    f_t, tot_t = _run_twin(params, mask, 1, f0)
    f_j, tot_j = _run_jnp(params, mask, 1, f0)
    rows = slice(row - 1, row + 2)
    np.testing.assert_allclose(f_t[:, rows], f_j[:, rows], rtol=0, atol=5e-8)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=5e-8)
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-6)


def test_apply_accel_row_and_stream_bitwise():
    """The injection and the streaming are single additions and moves: equal
    to lbm_tpu's bit for bit."""
    params, mask = _scene("32x64-block")
    rng = np.random.default_rng(3)
    f = rng.uniform(0.0, 2e-4, size=(9, params.ny, params.nx)).astype(np.float32)
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    row = params.accel_row
    got = fused_torch.apply_accel_row(
        torch.from_numpy(f[:, row]), torch.from_numpy(~mask[row]), float(w1), float(w2))
    want = fused_jnp.apply_accel_row(jnp.asarray(f[:, row]), jnp.asarray(~mask[row]), w1, w2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        fused_torch.stream_periodic(torch.from_numpy(f)).numpy(),
        np.asarray(fused_jnp.stream_periodic(jnp.asarray(f))),
    )


@pytest.mark.parametrize("name", ["16x16-fixture", "32x64-block"])
def test_twin_matches_oracle(name):
    params, mask = _scene(name)
    f_t, tot_t = _run_twin(params, mask, 120)
    f_o, av_o = oracle.run(params, mask, num_steps=120)
    fluid = np.float32(np.count_nonzero(~mask))
    np.testing.assert_allclose(f_t, f_o, atol=2e-7)
    np.testing.assert_allclose(tot_t / fluid, av_o, rtol=1e-4)


@pytest.fixture(scope="module")
def scene128():
    # the lane-aligned scene of tests/test_pallas.py:17-27
    params = _params(32, 128)
    mask = _box(32, 128, ((10, 12), (40, 44)))
    return params, mask


def test_k1_plain_matches_pallas_step(scene128):
    """Each step starts both sides from the same (Pallas) state, so the 1-ulp
    FMA differences cannot accumulate: per-step fields within atol 5e-8 and
    tot_u within rtol 1e-6.  Free-running, the fields stay within 5e-8 over
    the 6 steps, but tot_u drifts further (next test's note)."""
    params, mask = scene128
    step = jax.jit(fused_pallas.make_step(_jparams(params), mask, interpret=True))
    f_j = jnp.asarray(jlattice.equilibrium_rest(params.density, params.ny, params.nx))
    f_free = torch.from_numpy(np.array(f_j))
    obst = torch.from_numpy(mask)
    launches = LAUNCHES["K1"]
    for _ in range(6):
        f_t, tu_t = fused_cuda.step(torch.from_numpy(np.array(f_j)), obst, params)
        f_free, _ = fused_cuda.step(f_free, obst, params)
        f_j, tu_j = step(f_j)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=5e-8)
        np.testing.assert_allclose(float(tu_t), float(tu_j), rtol=1e-6)
    np.testing.assert_allclose(f_free.numpy(), np.asarray(f_j), rtol=0, atol=5e-8)
    assert LAUNCHES["K1"] == launches  # CPU tensors take the plain version


@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 4), (5, 8)])
def test_k2_plain_matches_pallas_resident(scene128, steps, chunk):
    """Free-running over the chunks.  Fields stay within atol 5e-8 (1 ulp).
    tot_u sums |u| from u = (f1+f5+f8 - f3-f6-f7)/rho, a difference of
    near-equal terms while the flow is slow: a 1-ulp difference in f moves
    u by ~1e-4 relative in a cell, and the sum by ~1e-5 (measured 1.07e-5 at
    step 3 of this scene).  So tot_u is held at rtol 1e-6 on the first step,
    where both sides start from the same state, and at rtol 1e-4 (the
    200-step bound of test_twin_matches_fused_jnp) after it."""
    params, mask = scene128
    f0 = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    run_j = jax.jit(resident_pallas.make_run_all(_jparams(params), mask, steps, chunk=chunk,
                                                 interpret=True))
    f_j, tot_j = run_j(jnp.asarray(f0))
    launches = LAUNCHES["K2"]
    run_t = resident_cuda.make_run_all(params, torch.from_numpy(mask), steps, chunk=chunk)
    f_t, tot_t = run_t(torch.from_numpy(f0))
    assert LAUNCHES["K2"] == launches  # CPU tensors take the plain version
    assert tot_t.shape == (steps,)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=5e-8)
    np.testing.assert_allclose(tot_t.numpy()[:1], np.asarray(tot_j)[:1], rtol=1e-6)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-4)
