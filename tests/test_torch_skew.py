"""K5 (the skewed sweep, ops/skew_cuda.py) against lbm_tpu's skewed pair.

On the CPU the wrapper runs the plain sweep (``fused_torch.run_sweeps``),
held here against ``lbm_tpu.ops.skew_pallas.make_run_all`` in interpret
mode, as tests/test_skew.py runs it, on the same numpy inputs.  A sweep of
the port is K steps; a pair of lbm_tpu's is 2K (a forward sweep that leaves
the state rotated and a reverse one that restores it).  So the step counts
compared split into whole sweeps and a K1 tail on both sides: 2K steps are
two sweeps here and one pair there; 21 steps at K=2 are ten sweeps and a
tail of 1 here, five pairs and a tail of 1 there.

Bounds are those of tests/test_temporal.py:48-49, fields atol 5e-7 and
tot_u rtol 1e-4 (XLA on the CPU contracts multiply-adds to FMAs, torch
does not; ROADMAP queue C).  In int16 a pair quantizes twice, after K and
after 2K steps, as two sweeps of the port do; the 1-ulp f32 noise flips an
int16 at a rounding tie in the first sweep and the flip feeds the second:
at most one quantization step, on under 5% of values (measured: 974 of
36864 at K=4).

Tests marked ``cuda`` hold K5 to its plain version on the card (fields
bitwise, tot_u rtol 1e-6) and skip without one.  As in
test_torch_temporal.py, lbm_tpu is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import quant, skew_cuda
from lbm_tpu_torch.params import LBMParams

from test_torch_temporal import _sweep_matches_plain, cuda_device  # noqa: F401

torch.set_num_threads(1)
DENSITY = 0.1


def _scene(ny, nx, seed):
    """tests/test_skew.py's scene: 8% random walls, walled top and bottom."""
    from lbm_tpu.params import LBMParams as JParams

    kw = dict(nx=nx, ny=ny, max_iters=16, reynolds_dim=10, density=DENSITY, accel=0.005,
              omega=1.85)
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return LBMParams(**kw), JParams(**kw), mask


@pytest.mark.parametrize(
    "ny,K,steps",
    [(32, 2, 4), (32, 4, 8), (32, 8, 16), (64, 2, 4), (64, 4, 8), (64, 8, 16), (32, 2, 21),
     (16, 4, 8)],
    ids=["32-K2", "32-K4", "32-K8", "64-K2", "64-K4", "64-K8", "32-K2x21-tail",
         "ny16-driven-row-in-wrap"],
)
def test_skew_plain_matches_b6(ny, K, steps):
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import skew_pallas

    params, jparams, mask = _scene(ny, 128, seed=K + ny)
    f0 = jlattice.equilibrium_rest(DENSITY, ny, 128)
    f_j, tot_j = skew_pallas.make_run_all(jparams, mask, steps, K)(jnp.asarray(f0))
    launches = skew_cuda.LAUNCHES
    f_t, tot_t = skew_cuda.make_run_all(params, torch.from_numpy(mask), steps, K)(
        torch.from_numpy(f0))
    assert skew_cuda.LAUNCHES == launches  # CPU tensors take the plain version
    assert tot_t.shape == (steps,)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=5e-7)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j, np.float32), rtol=1e-4)


@pytest.mark.parametrize("K", [2, 4])
def test_skew_i16_sweeps_match_b6_pair(K):
    """Two int16 sweeps against one int16 pair, from the same quantized
    (perturbed rest) state: each side quantizes after K and after 2K steps."""
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import skew_pallas

    params, jparams, mask = _scene(32, 128, seed=9)
    rng = np.random.default_rng(11)
    f0 = np.asarray(jlattice.equilibrium_rest(DENSITY, 32, 128))
    f0 = (f0 * (1 + 0.01 * rng.random(f0.shape, dtype=np.float32))).astype(np.float32)
    q0 = quant.quantize(torch.from_numpy(f0), DENSITY)
    q_j, tot_j = skew_pallas.make_run_all(jparams, mask, 2 * K, K, storage="i16")(
        jnp.asarray(q0.numpy()))
    q_t, tot_t = skew_cuda.make_run_all(params, torch.from_numpy(mask), 2 * K, K, "i16")(q0)
    assert q_t.dtype == torch.int16
    d = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert d.max() <= 1, f"max int16 diff {d.max()}"
    assert (d != 0).mean() < 0.05, f"{int((d != 0).sum())} values differ"
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-4)


def test_supports_and_geometry():
    def p(ny, nx):
        return LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                         accel=0.01, omega=1.85)

    assert skew_cuda.supports(p(32, 128), 2) and skew_cuda.supports(p(16, 16), 8)
    assert not skew_cuda.supports(p(32, 128), 1)
    assert not skew_cuda.supports(p(15, 40), 8)  # ny < 2K: no room for the warm-up
    assert not skew_cuda.supports(p(40, 15), 8)
    assert skew_cuda.supports(p(5, 100), 2)  # the driven row may lie anywhere
    assert not skew_cuda.supports(p(4096, 4096), 32)  # rings beyond shared memory
    assert skew_cuda.smem_bytes(2, 200, 64) is None  # wider than a step's loads
    assert skew_cuda.smem_bytes(8, 121, 64) is not None  # 8 x 137 - 72 cells: 4 per thread
    assert skew_cuda.smem_bytes(8, 122, 64) is None  # 4 and a bit
    for K in (2, 3, 4, 8):
        need = skew_cuda.smem_bytes(K, skew_cuda.STRIP_W, skew_cuda.BAND_H)
        assert need is not None and need <= 232448
    with pytest.raises(ValueError, match="cannot map"):
        skew_cuda.make_run_all(p(15, 40), torch.zeros((15, 40), dtype=torch.bool), 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(17, 40), (60, 100)], ids=str)
def test_k5_matches_plain_on_card(cuda_device, shape, K, kind, storage):  # noqa: F811
    _sweep_matches_plain(skew_cuda, cuda_device, shape, K, kind, storage)
