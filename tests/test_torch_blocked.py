"""K10 (the port of lbm_tpu's B4, ``resident_pallas._blocked_chunk_kernel``),
its plain version and the row-reduced |u| op, and the ``LBM_RESIDENT_KIND``
route to it.

Against ``lbm_tpu`` on the CPU its Pallas kernel runs in interpret mode and
XLA contracts multiply-adds into FMAs where torch does not (ROADMAP queue
C): fields within atol 5e-8 and tot_u within rtol 1e-5, the bounds
tests/test_pallas.py:174-191 holds ``lbm_tpu``'s own kernel to.  Inside the
port the relations are bitwise.  ``lbm_tpu`` is imported inside the tests
that compare against it, so that the card, which has no jax, runs the
``cuda`` ones:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_blocked.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import blocked_cuda, fused_torch, stencil_math
from lbm_tpu_torch.params import LBMParams, with_driven_row

torch.set_num_threads(1)


def _scene(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + 3, nx // 4: nx // 4 + 4] = True
    mask[ny - 2, nx // 2] = True  # a wall on the driven row
    mask[5, 7] = True  # and one on the row that first-block cases drive
    return params, mask


def _mixed(params, seed=3):
    """The rest state with a seeded 10% perturbation and the driven row's
    injection guard false at every third cell."""
    rng = np.random.default_rng(seed)
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
    w1, _ = lattice.accel_weights(params.density, params.accel)
    f[3, params.accel_row, ::3] = w1 * np.float32(0.5)
    return f


@pytest.mark.parametrize("masked", [False, True], ids=["all rows", "row mask"])
def test_collide_and_av_rows_matches_lbm_tpu(masked):
    import jax.numpy as jnp

    from lbm_tpu.ops import stencil_math as jstencil

    rng = np.random.default_rng(17)
    rows, nx = 12, 40
    rest = lattice.equilibrium_rest(0.1, rows, nx)
    planes = rest * (np.float32(1.0) + rng.uniform(-0.1, 0.1, rest.shape).astype(np.float32))
    obst = rng.random((rows, nx)) < 0.2
    row_mask = (np.arange(rows) % 3 != 0)[:, None] if masked else None
    omega = float(np.float32(1.85))
    out, vec = stencil_math.collide_and_av_rows(
        list(torch.from_numpy(planes)), torch.from_numpy(obst), omega,
        None if row_mask is None else torch.from_numpy(row_mask))
    j_out, j_vec = jstencil.collide_and_av_rows(
        list(jnp.asarray(planes)), jnp.asarray(obst), jnp.float32(omega),
        None if row_mask is None else jnp.asarray(row_mask))
    assert vec.shape == (1, nx) and j_vec.shape == (1, nx)
    np.testing.assert_allclose(torch.stack(out).numpy(), np.stack(j_out), atol=5e-8)
    np.testing.assert_allclose(vec.numpy(), np.asarray(j_vec), rtol=1e-6)
    # The partial is the rows added in row order, and its sum is
    # collide_and_av's up to the order of the additions.
    _, tot = stencil_math.collide_and_av(list(torch.from_numpy(planes)),
                                         torch.from_numpy(obst), omega)
    if not masked:
        torch.testing.assert_close(fused_torch.column_sum(vec), tot, rtol=1e-6, atol=0.0)


def test_column_sum_is_lbm_reduce_rows_order():
    """Thread t of 256 adds entries t, t + 256, ... in turn, then a halving
    tree: spelled out here in float32 numpy for 600 entries."""
    v = np.random.default_rng(2).random(600).astype(np.float32)
    acc = np.zeros(256, np.float32)
    for t in range(256):
        for b in range(t, 600, 256):
            acc[t] = np.float32(acc[t] + v[b])
    n = 256
    while n > 1:
        n //= 2
        acc[:n] = acc[:n] + acc[n:2 * n]
    assert fused_torch.column_sum(torch.from_numpy(v)).item() == acc[0]


# lbm_tpu's forced blocked kernel at its default limit takes 8-row blocks.
@pytest.mark.parametrize(
    "ny,steps,chunk,row",
    [(32, 5, 4, 30), (32, 7, 7, 16), (64, 6, 3, 5), (64, 7, 7, 39)],
    ids=lambda v: str(v))
def test_plain_b4_matches_lbm_tpu_blocked_kernel(ny, steps, chunk, row):
    """The plain B4 on 32x128 and 64x128 (4 and 8 row blocks of 8), the
    driven row in the first block, a middle one, on a block edge and in the
    last (its place in the scene), against lbm_tpu's B4 in interpret mode."""
    import jax
    import jax.numpy as jnp

    from lbm_tpu.ops import resident_pallas
    from lbm_tpu.params import LBMParams as JParams

    nx = 128
    params, mask = _scene(ny, nx)
    p = with_driven_row(params, row)
    jp = with_driven_row(JParams(**dataclasses.asdict(params)), row)
    f0 = _mixed(p)
    f_t, tot_t = blocked_cuda.run_plain(torch.from_numpy(f0), torch.from_numpy(mask), p, steps,
                                        block_rows=8)
    run = jax.jit(resident_pallas.make_run_all(jp, mask, steps, chunk=chunk, interpret=True,
                                               force_blocked=True, block_rows=8))
    f_j, tot_j = run(jnp.asarray(f0))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=5e-8)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-5)


@pytest.mark.parametrize("ny,nx,B", [(32, 128, 8), (30, 100, 8), (17, 33, 4), (9, 40, 16)],
                         ids=str)
def test_plain_b4_fields_equal_the_twin(ny, nx, B):
    """Row blocks change only the order of the |u| additions: fields equal
    the twin's bitwise at any ny (a partial last block) and any nx."""
    params, mask = _scene(ny, nx)
    f0, obst = torch.from_numpy(_mixed(params)), torch.from_numpy(mask)
    f_b, tot_b = fused_torch.blocked_chunk(f0, obst, params, 7, B)
    f_t, tot_t = fused_torch.run_steps(f0, obst, params, 7)
    assert torch.equal(f_b, f_t)
    torch.testing.assert_close(tot_b, tot_t, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 8), (5, 5), (0, 256), (9, 2)], ids=str)
def test_blocked_run_all_on_cpu_equals_plain(steps, chunk):
    params, mask = _scene(30, 100)
    f0, obst = torch.from_numpy(_mixed(params)), torch.from_numpy(mask)
    f_k, tot_k = blocked_cuda.make_run_all(params, obst, steps, chunk=chunk)(f0)
    f_p, tot_p = blocked_cuda.run_plain(f0, obst, params, steps)
    assert torch.equal(f_k, f_p) and torch.equal(tot_k, tot_p) and tot_k.shape == (steps,)


def test_blocked_refuses_int16_and_bad_blocks():
    params, mask = _scene(16, 16)
    with pytest.raises(ValueError, match="maps only the in-place resident kernel"):
        blocked_cuda.make_run_all(params, torch.from_numpy(mask), 4, storage="i16")
    with pytest.raises(ValueError, match="block_rows must divide 256"):
        blocked_cuda.make_run_all(params, torch.from_numpy(mask), 4, block_rows=3)


@pytest.mark.parametrize(
    "kind,grid,storage,want",
    [("mono", 64, "f32", "cuda-resident"), ("mono", 1024, "f32", None),
     ("mono", 64, "i16", None), ("inplace", 512, "f32", "cuda-inplace"),
     ("inplace", 2048, "f32", None), ("inplace", 256, "i16", "cuda-inplace-i16"),
     ("inplace", 512, "i16", None), ("blocked", 64, "f32", "cuda-blocked"),
     ("blocked", 4096, "f32", "cuda-blocked"), ("blocked", 64, "i16", None),
     ("auto", 64, "f32", "cuda-resident"), ("auto", 1024, "f32", "cuda-inplace")],
    ids=lambda v: str(v))
def test_resident_kind_policy(monkeypatch, kind, grid, storage, want):
    """LBM_RESIDENT_KIND forces K2, K3 or K10 whatever --temporal-k is, and
    raises where the kind cannot map; auto keeps the policy and never picks
    K10."""
    monkeypatch.setenv("LBM_RESIDENT_KIND", kind)
    p = LBMParams(nx=grid, ny=grid, max_iters=1, reynolds_dim=10, density=0.1, accel=0.01,
                  omega=1.85)
    for temporal_k in (None, 1, 4):
        if want is None:
            with pytest.raises(ValueError, match=f"LBM_RESIDENT_KIND={kind}"):
                program.cuda_choice(p, storage, temporal_k)
        elif kind == "auto":
            assert program.cuda_choice(p, storage)[0] == want
        else:
            assert program.cuda_choice(p, storage, temporal_k) == (want, 1)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "bogus")
    with pytest.raises(ValueError, match="LBM_RESIDENT_KIND='bogus'"):
        program.cuda_choice(p, storage)


def test_forced_blocked_run_through_the_driver(monkeypatch, capsys, tmp_path):
    """``LBM_RESIDENT_KIND=blocked`` runs cuda-blocked (K10's plain version
    on the CPU): fields equal the torch run's, av within float-sum order;
    a kind that cannot map exits 1 through the CLI."""
    from lbm_tpu_torch import cli
    from lbm_tpu_torch.tools import scenegen

    params, mask = _scene(24, 40)
    scene = Scene(params, mask)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "blocked")
    res = driver.run_simulation(scene, driver.RunConfig(variant="cuda", device="cpu",
                                                        num_steps=13, temporal_k=4))
    monkeypatch.delenv("LBM_RESIDENT_KIND")
    ref = driver.run_simulation(scene, driver.RunConfig(variant="torch", device="cpu",
                                                        num_steps=13))
    assert res.variant == "cuda-blocked"
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-6)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "mono")
    pfile, ofile = scenegen.write_scene(str(tmp_path), "cylinder", params)
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--storage", "i16",
                     "--out-dir", str(tmp_path / "out")]) == 1
    assert "LBM_RESIDENT_KIND=mono" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 8), (5, 5)], ids=str)
@pytest.mark.parametrize("shape,row", [((60, 100), 58), ((60, 100), 3), ((64, 64), 39),
                                       ((17, 33), 8)], ids=str)
def test_k10_matches_plain_on_card(cuda_device, shape, row, steps, chunk):
    params, mask = _scene(*shape)
    p = with_driven_row(params, row)
    f0 = torch.from_numpy(_mixed(p)).to(cuda_device)
    obst = torch.from_numpy(mask).to(cuda_device)
    f_k, tot_k = (t.clone() for t in blocked_cuda.make_run_all(p, obst, steps, chunk=chunk)(f0))
    f_p, tot_p = blocked_cuda.run_plain(f0, obst, p, steps)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_k10_counts_its_launches_and_refuses_cpu_state(cuda_device):
    params, mask = _scene(32, 64)
    obst = torch.from_numpy(mask).to(cuda_device)
    before = blocked_cuda.LAUNCHES
    run = blocked_cuda.make_run_all(params, obst, 600, chunk=256)
    f, tot = run(torch.from_numpy(_mixed(params)).to(cuda_device))
    assert blocked_cuda.LAUNCHES == before + 3 and tot.shape == (600,)
    assert bool(torch.isfinite(f).all())
    with pytest.raises(ValueError, match="state on the CPU"):
        run(torch.from_numpy(_mixed(params)))
