"""lbm_tpu_torch's int16 codec (ops/quant.py) and plain int16 step against
lbm_tpu's, on the same numpy inputs.

Tolerances: quantize is bitwise (a subtract, a multiply, round half to
even and a clamp, each one IEEE operation on both sides).  Dequantize
``q * inv + rest`` is held within 1 ulp: XLA on the CPU contracts it to an
FMA, torch does not (ROADMAP queue C).  The i16 step against B1's i16 form
(``fused_pallas.make_step(storage="i16", interpret=True)``) inherits that
1-ulp f32 noise, which flips an int16 at a rounding tie: at most one
quantization step on under 1% of cells, the bounds of
tests/test_vmem.py:255-299 for the same reason, held on each step from the
same state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlattice
from lbm_tpu.ops import fused_pallas
from lbm_tpu.ops import quant as jquant
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import fused_cuda, fused_torch, quant
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams

torch.set_num_threads(1)
DENSITY = 0.1


def _state(shape, spread, seed):
    rng = np.random.default_rng(seed)
    rest = lattice.equilibrium_rest(DENSITY, *shape)
    return (rest * (np.float32(1.0) + spread * rng.standard_normal(rest.shape))).astype(np.float32)


def test_constants_match_lbm_tpu():
    np.testing.assert_array_equal(quant.plane_scales(DENSITY), jquant.plane_scales(DENSITY))
    np.testing.assert_array_equal(quant.plane_rest(DENSITY), jquant.plane_rest(DENSITY))
    inv = quant.plane_inv_scales(DENSITY)
    assert inv.dtype == np.float32
    for k, s in enumerate(jquant.plane_scales(DENSITY)):
        assert inv[k] == np.float32(1.0 / float(s))
    c = quant.codec_constants(DENSITY)
    assert c.shape == (27,) and c.dtype == np.float32 and c.flags.c_contiguous
    np.testing.assert_array_equal(c[9:18], inv)
    assert quant.RANGE_C == jquant.RANGE_C


@pytest.mark.parametrize("spread", [0.15, 3.0], ids=["in-range", "saturating"])
def test_quantize_bitwise_equal_to_lbm_tpu(spread):
    f = _state((8, 128), spread, seed=0)
    got = quant.quantize(torch.from_numpy(f), DENSITY).numpy()
    want = np.asarray(jquant.quantize(jnp.asarray(f), DENSITY))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if spread > 1:
        assert got.max() == 32767 and got.min() == -32767


def test_dequantize_within_one_ulp_of_lbm_tpu():
    rng = np.random.default_rng(1)
    q = rng.integers(-32767, 32768, size=(9, 8, 128), dtype=np.int64).astype(np.int16)
    got = quant.dequantize(torch.from_numpy(q), DENSITY).numpy()
    want = np.asarray(jquant.dequantize(jnp.asarray(q), DENSITY))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_requantize_is_identity():
    """Bounce-back mirrors stored values: dequantize -> quantize must give
    back the same int16, so walls never drift (tests/test_quant.py:49-60)."""
    rng = np.random.default_rng(1)
    q0 = torch.from_numpy(
        rng.integers(-32767, 32768, size=(9, 8, 128), dtype=np.int64).astype(np.int16))
    assert torch.equal(quant.quantize(quant.dequantize(q0, DENSITY), DENSITY), q0)


def test_plane_codec():
    f = torch.from_numpy(_state((4, 16), 0.1, seed=2))
    deq, enq = quant.plane_codec("f32", DENSITY)
    assert deq(f[3], 3) is f[3] or torch.equal(deq(f[3], 3), f[3])
    assert torch.equal(enq(f[3], 3), f[3])
    deq, enq = quant.plane_codec("i16", DENSITY)
    assert torch.equal(enq(f[5], 5), quant.quantize_plane(f[5], 5, DENSITY))
    q = quant.quantize(f, DENSITY)
    assert torch.equal(deq(q[5], 5), quant.dequantize_plane(q[5], 5, DENSITY))
    with pytest.raises(ValueError, match="unknown storage"):
        quant.plane_codec("bf16", DENSITY)


def _box_params(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10,
                       density=DENSITY, accel=0.005, omega=1.85)
    jparams = JParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10,
                      density=DENSITY, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[12:16, 60:64] = True
    return params, jparams, mask


def test_i16_step_matches_pallas_i16():
    """The plain i16 step (the plain version of K1-i16 and K3-i16) against
    B1's i16 form on a 32x128 box with an interior block, from a perturbed
    rest state, 4 steps.  Each step starts both sides from the same (Pallas)
    state: free-running, the tie flips feed back through the quantization
    and compound (measured: 353 cells differ after 4 steps, up to 3 steps
    after 5; ROADMAP queue C).  Per step, 11-17 of 36864 values differed,
    by one step, and tot_u by at most 4.7e-7 relative."""
    params, jparams, mask = _box_params(32, 128)
    rng = np.random.default_rng(11)
    f0 = np.asarray(jlattice.equilibrium_rest(DENSITY, 32, 128))
    f0 = (f0 * (1 + 0.01 * rng.random((9, 32, 128), dtype=np.float32))).astype(np.float32)
    q0 = quant.quantize(torch.from_numpy(f0), DENSITY)
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jquant.quantize(jnp.asarray(f0), DENSITY)))
    step = jax.jit(fused_pallas.make_step(jparams, mask, storage="i16", interpret=True))
    q_j = jnp.asarray(q0.numpy())
    obst = torch.from_numpy(mask)
    launches = LAUNCHES["K1-i16"]
    for _ in range(4):
        q_t, tu_t = fused_cuda.step(torch.from_numpy(np.array(q_j)), obst, params, "i16")
        q_j, tu_j = step(q_j)
        assert q_t.dtype == torch.int16
        d = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
        assert d.max() <= 1, f"max int16 diff {d.max()}"
        assert (d != 0).mean() < 0.01, f"{int((d != 0).sum())} cells differ"
        np.testing.assert_allclose(float(tu_t), float(tu_j), rtol=1e-6)
    assert LAUNCHES["K1-i16"] == launches  # CPU tensors take the plain version


def test_i16_step_is_quantized_f32_step():
    """fused_step_i16 = quantize(fused_step_single(dequantize(q))), tot_u
    from the dequantized values; run_steps chains it."""
    params, _, mask = _box_params(32, 128)
    obst = torch.from_numpy(mask)
    q0 = quant.quantize(torch.from_numpy(_state((32, 128), 0.05, seed=4)), DENSITY)
    q1, tot = fused_torch.fused_step_i16(q0, obst, params)
    f1, tot_f = fused_torch.fused_step_single(quant.dequantize(q0, DENSITY), obst, params)
    assert torch.equal(q1, quant.quantize(f1, DENSITY)) and torch.equal(tot, tot_f)
    q3, tots = fused_torch.run_steps(q0, obst, params, 3, "i16")
    q, want = q0, []
    for _ in range(3):
        q, t = fused_torch.fused_step_i16(q, obst, params)
        want.append(t)
    assert torch.equal(q3, q) and torch.equal(tots, torch.stack(want))
    with pytest.raises(ValueError, match="unknown storage"):
        fused_torch.run_steps(q0, obst, params, 1, "i8")
