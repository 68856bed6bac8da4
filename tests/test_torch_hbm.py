"""lbm_tpu_torch's HBM-parts sweep K9 (ops/hbm_cuda.py): its plan, its plain
version against lbm_tpu's hbm_pallas in interpret mode, the forced
``LBM_TEMPORAL_IMPL=hbm`` path through the program and the CLI, and (marked
``cuda``) K9 against its plain version and against K1 on the card.

Against ``lbm_tpu`` on the CPU: fields within atol 5e-7 after 16 steps,
tot_u within rtol 1e-4 (tests/test_hbm.py's bounds: XLA contracts
multiply-adds into FMAs, torch does not, ROADMAP queue C).  On the card K9 is
held bitwise to its plain version and to K1.  lbm_tpu and jax are imported
inside the test that compares against them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hbm.py
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.models import program
from lbm_tpu_torch.ops import fused_cuda, hbm_cuda, inplace_cuda, resident_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)


def _scene(ny, nx, seed):
    """tests/test_hbm.py's scene: 8% random walls, walled top and bottom rows."""
    params = LBMParams(nx=nx, ny=ny, max_iters=16, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    r = np.random.default_rng(seed)
    mask = r.random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return params, mask


def test_plan_and_supports(monkeypatch):
    """R is the largest divisor of ny with K <= R, R + 2K <= ny and one f32
    copy of the (R + 2K, nx) slab within 36 MiB; no K % 8 rule, no
    three-part minimum; f32 only."""
    p, _ = _scene(64, 256, 0)
    assert hbm_cuda.plan(p, 8) == 32 and hbm_cuda.plan(p, 4) == 32
    assert hbm_cuda.plan(p, 2) == 32  # 60 rows would fit; 32 is the largest divisor
    assert hbm_cuda.plan(p, 3) == 32
    big = p.replace(ny=2048, nx=2048)
    assert hbm_cuda.plan(big, 4) == 256 and hbm_cuda.plan(big, 8) == 256
    assert hbm_cuda.plan(p.replace(ny=4096, nx=4096), 4) == 128
    assert hbm_cuda.plan(p.replace(ny=16, nx=24), 8) is None  # 2K = ny
    assert hbm_cuda.plan(p, 1) is None
    assert hbm_cuda.supports(p, 4) and not hbm_cuda.supports(p, 4, "i16")
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 0)
    assert hbm_cuda.plan(p, 4) is None
    obst = torch.zeros((64, 256), dtype=torch.bool)
    obst[2, 7] = True
    parts = hbm_cuda.part_obstacles(obst, 32, 4)  # rows [-4, 36) and [28, 68) mod 64
    assert parts.shape == (2, 40, 256) and parts.dtype == torch.uint8
    assert parts[0, 6, 7] == 1 and parts[1, 6, 7] == 0
    assert parts[1, 38, 7] == 1  # part 1's upper ghosts wrap to row 2


def test_plain_sweep_matches_lbm_tpu():
    """The plain hbm sweep (K twin steps per sweep) against
    hbm_pallas.make_run_all(interpret=True), 16 steps at K = 8 and 11 steps
    (a K1 tail), as tests/test_hbm.py:62-90."""
    import jax.numpy as jnp

    from lbm_tpu.ops import hbm_pallas
    from lbm_tpu.params import LBMParams as JParams

    p, mask = _scene(64, 256, 3)
    jp = JParams(nx=256, ny=64, max_iters=16, reynolds_dim=10, density=0.1, accel=0.005,
                 omega=1.85)
    f0 = lattice.equilibrium_rest(p.density, 64, 256)
    for steps in (16, 11):
        f_j, tot_j = hbm_pallas.make_run_all(jp, mask, steps, 8, interpret=True)(jnp.asarray(f0))
        run = hbm_cuda.make_run_all(p, torch.from_numpy(mask), steps, 8)
        f_p, tot_p = run(torch.from_numpy(f0))
        np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), atol=5e-7, rtol=0)
        np.testing.assert_allclose(tot_p.numpy(), np.asarray(tot_j), rtol=1e-4)


def test_forced_hbm_through_the_program(monkeypatch):
    """LBM_TEMPORAL_IMPL=hbm: cuda-hbm where K9 maps (the CPU runs its plain
    version: bitwise the K1 loop), and a ValueError where it does not; auto
    never takes it."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 2**20)
    p, mask = _scene(64, 100, 5)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL", raising=False)
    assert program.temporal_impl_choice(p, 4) == "trapezoid"
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "hbm")
    assert program.temporal_impl_choice(p, 4) == "hbm"
    assert program.temporal_impl_choice(p, 3) == "hbm"
    with pytest.raises(ValueError, match="cannot map"):
        program.temporal_impl_choice(p, 4, "i16")
    with pytest.raises(ValueError, match="cannot map"):
        program.temporal_impl_choice(p.replace(ny=12), 8)
    prog = program.build_single_program(p, mask, "cpu", backend="cuda", temporal_k=4)
    assert prog.variant == "cuda-hbm" and prog.sweep_k == 4
    f_h, tot_h = prog.make_run_all(14)(prog.init_state)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL")
    k1 = program.build_single_program(p, mask, "cpu", backend="cuda", temporal_k=1)
    f_1, tot_1 = k1.make_run_all(14)(k1.init_state)
    assert torch.equal(f_h, f_1)
    torch.testing.assert_close(tot_h, tot_1, rtol=1e-6, atol=0.0)


def test_cli_forced_hbm(tmp_path, capsys, monkeypatch):
    """``run --temporal-k 2`` under LBM_TEMPORAL_IMPL=hbm reports cuda-hbm
    and writes the K1 run's final_state.dat byte for byte."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    params = LBMParams(nx=24, ny=16, max_iters=9, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    outs = {}
    for impl, k in (("hbm", "2"), ("auto", "1")):
        monkeypatch.setenv("LBM_TEMPORAL_IMPL", impl)
        out = tmp_path / impl
        assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                         "--temporal-k", k, "--out-dir", str(out)]) == 0
        outs[impl] = out
    assert "Variant:\t\t\tcuda-hbm\n" in capsys.readouterr().out
    assert ((outs["hbm"] / "final_state.dat").read_bytes()
            == (outs["auto"] / "final_state.dat").read_bytes())


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _start(p, kind, device):
    f = lattice.equilibrium_rest(p.density, p.ny, p.nx)
    if kind == "mixed":
        rng = np.random.default_rng(11)
        f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
        w1, _ = lattice.accel_weights(p.density, p.accel)
        f[3, p.accel_row, ::3] = w1 * np.float32(0.5)
    return torch.from_numpy(f).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(64, 256), (60, 100)], ids=str)
def test_k9_matches_plain_and_k1_on_card(cuda_device, shape, K, kind):
    """K9 over 2K + 1 steps (two sweeps and a K1 tail) against its plain
    version and against the K1 loop: fields equal, tot_u within rtol 1e-6;
    its launches counted."""
    p, mask = _scene(*shape, 7)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(p, kind, cuda_device)
    steps = 2 * K + 1
    before = hbm_cuda.LAUNCHES
    f_k, tot_k = (t.clone() for t in hbm_cuda.make_run_all(p, obst, steps, K)(f0))
    assert hbm_cuda.LAUNCHES == before + 2
    f_p, tot_p = hbm_cuda.run_plain(f0, obst, p, steps, K)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)
    f_1, tot_1 = fused_cuda.make_run_all(p, obst, steps)(f0)
    assert torch.equal(f_k, f_1)
    torch.testing.assert_close(tot_k, tot_1, rtol=1e-6, atol=0.0)
