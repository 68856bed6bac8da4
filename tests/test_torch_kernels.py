"""lbm_tpu_torch's CUDA kernels and their wrappers.

Tests marked ``cuda`` need a CUDA device and skip without one; on the card
each kernel is held to its plain version: fields bitwise, per-step tot_u
within rtol 1e-6 (the sums are taken in another order).  Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use).  The rest run anywhere: wrappers on CPU tensors, the program's kernel
policy, the build plumbing and chip_smoke.py's refusal without a card.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import (
    _build,
    ensemble_cuda,
    fused_cuda,
    fused_torch,
    inplace_cuda,
    quant,
    resident_cuda,
)
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import kernel_times

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _scene(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + 3, nx // 4: nx // 4 + 4] = True
    mask[ny - 2, nx // 2] = True  # a wall on the driven row
    return params, mask


def _state(params, kind, device):
    """``rest``: the equilibrium start.  ``mixed``: the rest state with a
    seeded random 10% perturbation (numpy) and the driven row's injection
    guard false at every third cell."""
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    if kind == "mixed":
        rng = np.random.default_rng(11)
        f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
        w1, _ = lattice.accel_weights(params.density, params.accel)
        f[3, params.accel_row, ::3] = w1 * np.float32(0.5)
    return torch.from_numpy(f).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_matches(f_k, tot_k, f_p, tot_p):
    assert bool(torch.isfinite(f_p).all())
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("shape", [(60, 100), (32, 64), (7, 33)], ids=str)
def test_k1_matches_plain_on_card(cuda_device, shape, kind):
    params, mask = _scene(*shape)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, kind, cuda_device)
    before = LAUNCHES["K1"]
    f_k, tot_k = fused_cuda.make_run_all(params, obst, 20)(f0)
    assert LAUNCHES["K1"] == before + 20
    f_p, tot_p = fused_cuda.run_plain(f0, obst, params, 20)
    _assert_matches(f_k, tot_k, f_p, tot_p)
    one, tot_one = fused_cuda.step(f0, obst, params)
    f_1, tot_1 = fused_cuda.step_plain(f0, obst, params)
    _assert_matches(one, tot_one.reshape(1), f_1, tot_1.reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1-batch", "K2-batch", "K11"])
@pytest.mark.parametrize("shape,B,geometry", [((60, 100), 3, False), ((7, 33), 5, False),
                                              ((30, 129), 2, True), ((7, 33), 200, False)],
                         ids=str)
def test_ensemble_kernels_match_plain_on_card(cuda_device, shape, B, geometry, kernel):
    """K1-batch (20 steps), K2-batch and K11 (300: two chunks) against the
    plain batched step, fields bitwise; every instance against a single K1
    or K2 run of its omega, accel (1.0: the guard split on the driven row)
    and mask; a second run bitwise.  200 x 7x33 puts K11 at C = 1 (one
    block an instance; on the H100 in one wave of 512-thread blocks, two an
    SM).  K11's launches take its plan's block shape and C: the card's
    ``cluster_plan`` for the shape."""
    params, mask = _scene(*shape)
    masks = np.stack([mask] * B)
    if geometry:
        masks[1, 2:4, 3:9] = True
    obst = torch.from_numpy(masks if geometry else mask).to(cuda_device)
    f0 = torch.stack([_state(params.replace(accel=0.01 * (b + 1)), "mixed", cuda_device)
                      for b in range(B)]).contiguous()
    omegas = np.linspace(0.7, 1.9, B, dtype=np.float32)
    accels = np.asarray([(0.005, 1.0)[b % 2] for b in range(B)], dtype=np.float32)
    steps = 20 if kernel == "K1-batch" else 300
    counts = {k: LAUNCHES[k] for k in ensemble_cuda.KERNELS}
    run = ensemble_cuda.make_run_all(params, obst, omegas, accels, steps, kernel=kernel)
    assert run.kernel == kernel and (run.plan is not None) == (kernel == "K11")
    f_k, tot_k = (t.clone() for t in run(f0))
    assert tuple(LAUNCHES[k] - counts[k] for k in ensemble_cuda.KERNELS) == {
        "K1-batch": (steps, 0, 0), "K2-batch": (0, 2, 0), "K11": (0, 0, 2)}[kernel]
    if run.plan is not None:  # the form K11 launched in: the card's plan for the shape
        assert run.plan == ensemble_cuda.cluster_plan(
            *shape, B, ensemble_cuda.card_clusters(_build.load(), cuda_device.index))
    f_p, tot_p = ensemble_cuda.run_plain(f0, obst, params, omegas, accels, steps)
    _assert_matches(f_k, tot_k, f_p, tot_p)
    f_2, tot_2 = run(f0)
    assert torch.equal(f_2, f_k) and torch.equal(tot_2, tot_k)
    for b in range(B):
        pb = params.replace(omega=float(omegas[b]), accel=float(accels[b]))
        ob = obst[b].contiguous() if geometry else obst
        if kernel == "K1-batch":
            f_1, tot_1 = fused_cuda.make_run_all(pb, ob, steps)(f0[b].contiguous())
            assert torch.equal(f_1, f_k[b]) and torch.equal(tot_1, tot_k[:, b])
        else:
            f_1, _ = resident_cuda.make_run_all(pb, ob, steps)(f0[b].contiguous())
            assert torch.equal(f_1, f_k[b])


@pytest.mark.cuda
def test_k11_forced_where_no_cluster_holds_an_instance_raises(cuda_device):
    """512^2: a band of 32 rows at C = 16 needs more than a block's shared
    memory, so a forced K11 raises before any launch, and the policy runs
    K2-batch there."""
    params, mask = _scene(512, 512)
    obst = torch.from_numpy(mask).to(cuda_device)
    with pytest.raises(ValueError, match="K11 cannot map 512x512"):
        ensemble_cuda.make_run_all(params, obst, [1.2, 1.8], None, 10, kernel="K11")
    assert ensemble_cuda.make_run_all(params, obst, [1.2, 1.8], None, 10).kernel == "K2-batch"


def test_ensemble_runner_on_cpu_is_the_plain_batched_step():
    params, mask = _scene(12, 20)
    obst = torch.from_numpy(mask)
    f0 = torch.stack([_state(params, "mixed", "cpu")] * 2).contiguous()
    for kernel in (None, "K1-batch", "K2-batch", "K11"):
        run = ensemble_cuda.make_run_all(params, obst, [1.2, 1.8], [0.005, 1.0], 5, kernel)
        f_k, tot_k = run(f0)
        f_p, tot_p = ensemble_cuda.run_plain(f0, obst, params, [1.2, 1.8], [0.005, 1.0], 5)
        assert run.kernel == "plain" and torch.equal(f_k, f_p) and torch.equal(tot_k, tot_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 4), (5, 8), (40, 16)])
def test_k2_matches_plain_on_card(cuda_device, steps, chunk, kind):
    params, mask = _scene(32, 64)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, kind, cuda_device)
    before = LAUNCHES["K2"]
    f_k, tot_k = resident_cuda.make_run_all(params, obst, steps, chunk=chunk)(f0)
    assert LAUNCHES["K2"] == before + -(-steps // chunk)
    f_p, tot_p = resident_cuda.run_plain(f0, obst, params, steps)
    _assert_matches(f_k, tot_k, f_p, tot_p)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3, 8, 256])
@pytest.mark.parametrize("shape", [(30, 129), (7, 1000), (45, 33)], ids=str)
def test_k2_band_edges_match_plain_on_card(cuda_device, shape, chunk):
    """K2 where the blocks' bands (the band plan on the card's grid) end
    mid-row: on 30x129 and 7x1000 the driven row is a band's first row and
    another's last, rows split two and four ways; 45x33 bands span rows.
    Two chunks and a 1-step remainder, the step counters running on from
    launch to launch, from the mixed start."""
    ny, nx = shape
    params, mask = _scene(ny, nx)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, "mixed", cuda_device)
    grid = _build.load().lbm_resident_grid(ny, nx, cuda_device.index)
    plan = resident_cuda.grid_plan(ny, nx, grid)[0]
    if shape != (45, 33):
        assert any(s % nx for s, _, _, _ in plan)
        assert any(s // nx == params.accel_row for s, _, _, _ in plan)
        assert any((e - 1) // nx == params.accel_row for _, e, _, _ in plan)
    steps = 2 * chunk + 1
    before = LAUNCHES["K2"]
    f_k, tot_k = resident_cuda.make_run_all(params, obst, steps, chunk=chunk)(f0)
    assert LAUNCHES["K2"] == before + 3
    f_p, tot_p = resident_cuda.run_plain(f0, obst, params, steps)
    _assert_matches(f_k, tot_k, f_p, tot_p)


def _start(params, kind, device, storage):
    f = _state(params, kind, device)
    return quant.quantize(f, params.density) if storage == "i16" else f


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("steps,chunk", [(1, 4), (7, 4), (8, 4), (5, 8), (40, 16)])
@pytest.mark.parametrize("shape", [(60, 100), (7, 33), (5, 6)], ids=str)
def test_k3_matches_plain_on_card(cuda_device, shape, steps, chunk, kind, storage):
    params, mask = _scene(*shape)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(params, kind, cuda_device, storage)
    kernel = "K3-i16" if storage == "i16" else "K3"
    before = LAUNCHES[kernel]
    run = inplace_cuda.make_run_all(params, obst, steps, chunk=chunk, storage=storage)
    f_k, tot_k = run(f0)
    assert LAUNCHES[kernel] == before + -(-steps // chunk)
    f_p, tot_p = inplace_cuda.run_plain(f0, obst, params, steps, storage)
    assert f_k.dtype == f0.dtype
    _assert_matches(f_k, tot_k, f_p, tot_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("shape", [(60, 100), (7, 33)], ids=str)
def test_k1_i16_matches_plain_on_card(cuda_device, shape, kind):
    params, mask = _scene(*shape)
    obst = torch.from_numpy(mask).to(cuda_device)
    q0 = _start(params, kind, cuda_device, "i16")
    before = LAUNCHES["K1-i16"]
    q_k, tot_k = fused_cuda.make_run_all(params, obst, 20, "i16")(q0)
    assert LAUNCHES["K1-i16"] == before + 20
    q_p, tot_p = fused_cuda.run_plain(q0, obst, params, 20, "i16")
    assert q_k.dtype == torch.int16
    _assert_matches(q_k, tot_k, q_p, tot_p)


# K1-i16 takes two columns a lane and one row a warp, 64 x 8 cells a block:
# nx below, at and just above a warp's 64 columns, odd and even (odd nx and
# nx = 1 take 16-bit accesses), and the driven row (ny - 2) on the first
# (ny = 10) and the last (ny = 17) row of a block's 8 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("shape", [(10, 33), (17, 33), (10, 64), (17, 64), (10, 65), (17, 65),
                                   (10, 130), (17, 2), (10, 1)], ids=str)
def test_k1_i16_edge_shapes_match_plain_on_card(cuda_device, shape, kind):
    params, mask = _scene(*shape)
    obst = torch.from_numpy(mask).to(cuda_device)
    q0 = _start(params, kind, cuda_device, "i16")
    q_k, tot_k = fused_cuda.make_run_all(params, obst, 7, "i16")(q0)
    q_p, tot_p = fused_cuda.run_plain(q0, obst, params, 7, "i16")
    _assert_matches(q_k, tot_k, q_p, tot_p)


# K1-slab-i16 on the same columns, one body row and more, the driven row on
# the first and the last body row, in either ghost and in none; the whole
# slab and overlap's edge windows of one shard tensor (body rows as ghosts,
# the output a window of the new state).
@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "last", "lo", "hi", "none"])
@pytest.mark.parametrize("nx", [33, 64, 65])
def test_k1_slab_i16_edge_shapes_match_plain_on_card(cuda_device, nx, where):
    params = LBMParams(nx=nx, ny=64, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)  # the grid the shard is cut from: driven row 62
    for n in (1, 9):
        slab_params, mask = _scene(n + 2, nx)  # the slab's rows, ghosts included
        x = quant.quantize(_state(slab_params, "mixed", cuda_device), params.density)
        m = torch.from_numpy(mask).to(cuda_device)
        shard, lo, hi = x[:, 1:-1].contiguous(), x[:, :1].clone(), x[:, -1:].clone()
        forms = [(shard, lo, hi, m, slice(None), n)]
        if n > 1:
            forms += [(shard[:, :1], lo, shard[:, 1:2], m[:3], slice(0, 1), 1),
                      (shard[:, -1:], shard[:, -2:-1], hi, m[-3:], slice(n - 1, n), 1)]
        for body, glo, ghi, ob, win, rows in forms:
            off = {"first": params.accel_row, "last": params.accel_row - rows + 1,
                   "lo": params.accel_row + 1, "hi": params.accel_row - rows, "none": 0}[where]
            new = torch.zeros_like(shard)
            tots = torch.zeros(1, dtype=torch.float32, device=cuda_device)
            before = LAUNCHES["K1-slab-i16"]
            fused_cuda.bind_slab_step(params, body, glo, ghi, ob.contiguous(), new[:, win], tots,
                                      off, "i16")(0)
            assert LAUNCHES["K1-slab-i16"] == before + 1
            ref, ref_tot = fused_cuda.slab_plain(body, glo, ghi, ob, params, off, "i16")
            _assert_matches(new[:, win], tots, ref, ref_tot.reshape(1))


# K1-i16 and K1-slab-i16 take long long offsets once 9 planes (or 8 plane
# strides and the body) reach 2^31 elements, int below.  Full grids with 9
# ny nx just above 2^31 (32- and 16-bit accesses), from a seeded 64-row
# field repeated down the grid.
@pytest.mark.cuda
@pytest.mark.parametrize("nx", [14564, 14565])
def test_k1_i16_wide_offsets_match_plain_on_card(cuda_device, nx):
    ny = 16384
    assert 9 * ny * nx >= 2**31
    params, mask = _scene(ny, nx)
    obst = torch.from_numpy(mask).to(cuda_device)
    band, _ = _scene(64, nx)
    q0 = _start(band, "mixed", cuda_device, "i16").repeat(1, ny // 64, 1)
    q_k, tot_k = fused_cuda.make_run_all(params, obst, 2, "i16")(q0)
    q_p, tot_p = fused_cuda.run_plain(q0, obst, params, 2, "i16")
    _assert_matches(q_k, tot_k, q_p, tot_p)


# K1-slab-i16 on windows of one tensor whose planes lie 2^28 elements or
# more apart (plane 8 beyond 2^31): the ghosts, the body and the output.
@pytest.mark.cuda
@pytest.mark.parametrize("nx", [64, 65])
def test_k1_slab_i16_wide_offsets_match_plain_on_card(cuda_device, nx):
    params = LBMParams(nx=nx, ny=64, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)  # driven row 62
    n = 9
    rows = -(-(2**28) // nx)
    big = torch.zeros((9, rows, nx), dtype=torch.int16, device=cuda_device)
    slab_params, mask = _scene(n + 2, nx)
    big[:, :n + 2] = quant.quantize(_state(slab_params, "mixed", cuda_device), params.density)
    body, lo, hi, out = big[:, 1:n + 1], big[:, :1], big[:, n + 1:n + 2], big[:, rows - n:]
    m = torch.from_numpy(mask).to(cuda_device)
    for off in (params.accel_row, params.accel_row - n + 1, params.accel_row + 1, 0):
        tots = torch.zeros(1, dtype=torch.float32, device=cuda_device)
        fused_cuda.bind_slab_step(params, body, lo, hi, m, out, tots, off, "i16")(0)
        ref, ref_tot = fused_cuda.slab_plain(body, lo, hi, m, params, off, "i16")
        _assert_matches(out, tots, ref, ref_tot.reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_k3_and_i16_deterministic_and_segmentable_on_card(cuda_device, storage):
    params, mask = _scene(48, 40)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(params, "mixed", cuda_device, storage)
    makers = [lambda n: inplace_cuda.make_run_all(params, obst, n, chunk=8, storage=storage)]
    if storage == "i16":
        makers.append(lambda n: fused_cuda.make_run_all(params, obst, n, "i16"))
    for make in makers:
        odd = make(7)(f0)[0].clone()  # an odd run ends in the second buffer
        assert torch.equal(odd, make(7)(f0)[0])
        f_a, tot_a = make(30)(f0)
        f_a, tot_a = f_a.clone(), tot_a.clone()
        f_b, tot_b = make(30)(f0)
        assert torch.equal(f_a, f_b) and torch.equal(tot_a, tot_b)
        seg = make(10)
        f_s, parts = f0, []
        for _ in range(3):
            f_s, t = seg(f_s)
            parts.append(t.clone())
        assert torch.equal(f_s, f_a)
        assert torch.equal(torch.cat(parts), tot_a)
    assert torch.equal(f0, _start(params, "mixed", cuda_device, storage))  # f0 untouched


@pytest.mark.cuda
def test_k3_and_i16_wrappers_reject_bad_input_on_card(cuda_device):
    params, mask = _scene(16, 24)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, "rest", cuda_device)
    q0 = quant.quantize(f0, params.density)
    runs = [(inplace_cuda.make_run_all(params, obst, 3), f0),
            (inplace_cuda.make_run_all(params, obst, 3, storage="i16"), q0),
            (fused_cuda.make_run_all(params, obst, 3, "i16"), q0)]
    for run, good in runs:
        with pytest.raises(ValueError):
            run(good.double())
        with pytest.raises(ValueError):
            run(good[:, :, :-1])
        with pytest.raises(ValueError):
            run(good.cpu())
    with pytest.raises(ValueError):
        runs[1][0](f0)  # f32 state to an int16 runner
    with pytest.raises(ValueError):
        runs[0][0](q0)
    with pytest.raises(ValueError):
        inplace_cuda.make_run_all(params, obst.to(torch.uint8), 3)


@pytest.mark.cuda
def test_cuda_i16_run_on_card(cuda_device):
    params, mask = _scene(32, 48)
    scene = Scene(params, mask)
    res = driver.run_simulation(scene, driver.RunConfig(variant="cuda", num_steps=25,
                                                        storage="i16"))
    ref = driver.run_simulation(scene, driver.RunConfig(variant="cuda", device="cpu",
                                                        num_steps=25, storage="i16"))
    assert res.variant == ref.variant == "cuda-inplace-i16"
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-6)


@pytest.mark.cuda
def test_kernels_deterministic_and_segmentable_on_card(cuda_device):
    params, mask = _scene(48, 40)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, "rest", cuda_device)
    for make in (fused_cuda.make_run_all, resident_cuda.make_run_all):
        f_a, tot_a = make(params, obst, 30)(f0)
        f_a, tot_a = f_a.clone(), tot_a.clone()
        f_b, tot_b = make(params, obst, 30)(f0)
        assert torch.equal(f_a, f_b) and torch.equal(tot_a, tot_b)
        seg = make(params, obst, 10)
        f_s, parts = f0, []
        for _ in range(3):
            f_s, t = seg(f_s)
            parts.append(t.clone())
        assert torch.equal(f_s, f_a)
        assert torch.equal(torch.cat(parts), tot_a)


@pytest.mark.cuda
def test_wrappers_reject_bad_input_on_card(cuda_device):
    params, mask = _scene(16, 24)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, "rest", cuda_device)
    for make in (fused_cuda.make_run_all, resident_cuda.make_run_all):
        run = make(params, obst, 3)
        with pytest.raises(ValueError):
            run(f0.double())
        with pytest.raises(ValueError):
            run(f0[:, :, :-1])
        with pytest.raises(ValueError):
            run(f0.transpose(1, 2).contiguous().transpose(1, 2))
        with pytest.raises(ValueError):
            run(f0.cpu())
        with pytest.raises(ValueError):
            make(params, obst.to(torch.uint8), 3)


@pytest.mark.cuda
def test_cuda_run_equals_torch_run_on_card(cuda_device):
    params, mask = _scene(32, 48)
    scene = Scene(params, mask)
    res_k = driver.run_simulation(scene, driver.RunConfig(variant="cuda", num_steps=25))
    res_t = driver.run_simulation(scene, driver.RunConfig(variant="torch", num_steps=25))
    assert res_k.variant == "cuda-resident"
    np.testing.assert_array_equal(res_k.f, res_t.f)
    np.testing.assert_allclose(res_k.av_vels, res_t.av_vels, rtol=1e-6)


@pytest.mark.cuda
def test_kernel_times_on_card(cuda_device):
    times = kernel_times.time_grid(32, cuda_device, repeats=2)
    assert set(times) == set(kernel_times.F32_KERNELS + kernel_times.I16_KERNELS)
    for med, q1, q3 in times.values():
        assert 0 < q1 <= med <= q3
    med, q1, q3 = kernel_times.copy_gbps(cuda_device, repeats=2, nbytes=2**24)
    assert 0 < q1 <= med <= q3
    for barrier in (True, False):
        med, q1, q3 = kernel_times.l2_copy_gbps(cuda_device, 2**20, barrier, passes=4,
                                                repeats=2)
        assert 0 < q1 <= med <= q3


def test_kernel_times_variants_and_l2_tiers():
    """``--variant`` specs, which kernels a replaced source or header
    reaches, and the L2 working set a kernel's tier bound divides by."""
    name, files, region = kernel_times.parse_variant("p=a/inplace.cu+b/aa_inplace.cuh@48x64")
    assert (name, sorted(files), region) == ("p", ["aa_inplace.cuh", "inplace.cu"], (48, 64))
    with pytest.raises(ValueError):
        kernel_times.parse_variant("p=")
    v = {n: kernel_times.Variant(None, None, frozenset(f)) for n, f in (
        ("k3", {"inplace.cu"}), ("aa", {"aa_inplace.cuh"}), ("k4", {"temporal.cu"}))}
    assert set(kernel_times.replacing(v, "inplace.cu")) == {"k3", "aa"}
    assert set(kernel_times.replacing(v, "ca_inplace.cu")) == {"aa"}
    assert set(kernel_times.replacing(v, "hbm.cu")) == {"aa"}  # through two_copy.cuh
    assert set(kernel_times.replacing(v, "temporal.cu")) == {"k4"}
    rates = {lb: {"barrier": (float(i + 1), 0.0, 0.0)}
             for i, lb in enumerate(kernel_times.L2_WORKING_SETS)}
    sets = kernel_times.L2_WORKING_SETS
    assert kernel_times.l2_rate_for(rates, 1) == ("9.6 MiB", 1.0)
    assert kernel_times.l2_rate_for(rates, sets["9.6 MiB"] + 1) == ("18 MiB", 2.0)
    assert kernel_times.l2_rate_for(rates, sets["36 MiB"]) == ("36 MiB", 3.0)
    assert kernel_times.l2_rate_for(rates, 10 * sets["36 MiB"]) == ("36 MiB", 3.0)
    assert "36 MiB barrier 3.0" in kernel_times.format_l2(
        {lb: {"barrier": r["barrier"], "free": r["barrier"]} for lb, r in rates.items()})


def test_kernel_times_sweep_split():
    """``--hbm-split``: each part of the split keeps K8's cell loop once,
    under its condition on the step (K9 of hbm.cu, and K8's walk in
    ca_inplace.cu, which PRs 5-13's K9 ran on); a source without the loop
    raises."""
    for name in ("hbm.cu", "ca_inplace.cu"):
        text = (_build.CSRC / name).read_text()
        for part, cond in kernel_times.SWEEP_SPLIT.items():
            out = kernel_times.split_source(text, part)
            assert out.count(f"({cond}) && c0 < bd.end;") == 1
            assert len(out) == len(text) + len(cond) + 6
    with pytest.raises(ValueError, match="cell loop"):
        kernel_times.split_source("int main() {}", "floor")
    assert set(kernel_times.SWEEP_SPLIT) == {"floor", "step0", "middle", "last"}


def test_kernel_times_hbm_tier():
    """K9's L2 tier bound: the plan's parts' cell-steps, 72 bytes each, over
    the rate given (2048^2, K = 4: 8 parts of 264 rows)."""
    assert kernel_times.hbm_tier_ms(2048, 4, 1.0) == pytest.approx(
        8 * 264 * 2048 * 4 * 72 / 1e9 * 1e3)
    assert kernel_times.hbm_tier_ms(4096, 8, 2.0) == pytest.approx(
        32 * 144 * 4096 * 8 * 72 / 2e9 * 1e3)


def test_kernel_times_two_copy_variants():
    """A variant of ``ca_resident.cu`` (K7) or ``blocked.cu`` (K10) is timed
    as theirs, and one of ``two_copy.cuh`` reaches K2, K6, K7 and K10 (every
    source that includes it), not K3 or K8."""
    v = {n: kernel_times.Variant(None, None, frozenset(f)) for n, f in (
        ("k7", {"ca_resident.cu"}), ("k10", {"blocked.cu"}), ("two", {"two_copy.cuh"}))}
    assert set(kernel_times.replacing(v, "ca_resident.cu")) == {"k7", "two"}
    assert set(kernel_times.replacing(v, "blocked.cu")) == {"k10", "two"}
    for source in ("resident.cu", "ghosted.cu"):
        assert set(kernel_times.replacing(v, source)) == {"two"}
    for source in ("inplace.cu", "ca_inplace.cu"):
        assert not kernel_times.replacing(v, source)


def test_kernel_times_report(monkeypatch, capsys):
    line = kernel_times.format_grid(128, {"K1": (2.0, 1.5, 2.5), "twin": (100.0, 90.0, 110.0)})
    assert line == ("128^2: K1 2.000 us/step [1.500, 2.500] 8192 MLUPS 598 GB/s | "
                    "twin 100.000 us/step [90.000, 110.000] 164 MLUPS 12 GB/s")
    assert kernel_times._quartiles([3.0]) == (3.0, 3.0, 3.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_times.main(["--grids", "16"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cpu_tensors_take_the_plain_version():
    params, mask = _scene(16, 24)
    obst = torch.from_numpy(mask)
    f0 = _state(params, "mixed", "cpu")
    k1, k2 = LAUNCHES["K1"], LAUNCHES["K2"]
    f_p, tot_p = fused_torch.run_steps(f0, obst, params, 9)
    for run in (fused_cuda.make_run_all(params, obst, 9),
                resident_cuda.make_run_all(params, obst, 9, chunk=4)):
        f, tot = run(f0)
        assert torch.equal(f, f_p) and torch.equal(tot, tot_p)
    f1, tot1 = fused_cuda.step(f0, obst, params)
    f1_p, tot1_p = fused_torch.fused_step_single(f0, obst, params)
    assert torch.equal(f1, f1_p) and torch.equal(tot1, tot1_p)
    assert (LAUNCHES["K1"], LAUNCHES["K2"]) == (k1, k2)
    # f0 is never modified
    assert torch.equal(f0, _state(params, "mixed", "cpu"))


def test_other_devices_raise():
    params, mask = _scene(8, 8)
    f = torch.empty((9, 8, 8), device="meta")
    obst = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_cuda.step(f, obst, params)
    with pytest.raises(ValueError):
        fused_cuda.make_run_all(params, obst, 2)(f)
    with pytest.raises(ValueError):
        resident_cuda.make_run_all(params, obst, 2)(f)


def test_kernel_policy(monkeypatch):
    assert resident_cuda.fits_l2(128, 128) and resident_cuda.fits_l2(256, 256)
    assert resident_cuda.fits_l2(512, 512)  # 18 MiB of ping-pong state
    assert resident_cuda.fits_l2(768, 768)  # 40.5 MiB
    assert not resident_cuda.fits_l2(1024, 1024)  # 72 MiB
    params, mask = _scene(16, 24)
    prog = program.build_single_program(params, mask, torch.device("cpu"), backend="cuda")
    assert prog.variant == "cuda-resident" and prog.tot_cells == int((~mask).sum())
    f1, tot1 = prog.step(prog.init_state)
    f1_p, tot1_p = fused_torch.fused_step_single(prog.init_state, torch.from_numpy(mask), params)
    assert torch.equal(f1, f1_p) and torch.equal(tot1, tot1_p)
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 1024)
    prog = program.build_single_program(params, mask, torch.device("cpu"), backend="cuda")
    assert prog.variant == "cuda-inplace"
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 1024)
    prog = program.build_single_program(params, mask, torch.device("cpu"), backend="cuda")
    assert prog.variant == "cuda-step"
    f, tot = prog.make_run_all(5)(prog.init_state)
    f_p, tot_p = fused_torch.run_steps(prog.init_state, torch.from_numpy(mask), params, 5)
    assert torch.equal(f, f_p) and torch.equal(tot, tot_p)
    assert program.build_single_program(params, mask, "cpu").variant == "torch"
    with pytest.raises(ValueError):
        program.build_single_program(params, mask, "cpu", backend="pallas")
    with pytest.raises(ValueError):
        program.build_single_program(params, mask, "cpu", f0=np.zeros((9, 3, 3), np.float32))


def test_kernel_policy_inplace_and_i16(monkeypatch):
    """The variant names by grid and budget: K2, K3 or a K1 loop for f32;
    K3-i16 or a K1-i16 loop for i16 (which needs the cuda backend)."""
    params, mask = _scene(16, 24)
    obst = torch.from_numpy(mask)
    cpu = torch.device("cpu")
    build = program.build_single_program
    prog = build(params, mask, cpu, backend="cuda", storage="i16")
    assert prog.variant == "cuda-inplace-i16"
    assert prog.init_state.dtype == torch.int16
    assert torch.equal(prog.f_of(prog.init_state),
                       quant.dequantize(prog.init_state, params.density))
    q, tot = prog.make_run_all(5)(prog.init_state)
    q_p, tot_p = fused_torch.run_steps(prog.init_state, obst, params, 5, "i16")
    assert torch.equal(q, q_p) and torch.equal(tot, tot_p)
    q1, tot1 = prog.step(prog.init_state)
    q1_p, tot1_p = fused_torch.fused_step_i16(prog.init_state, obst, params)
    assert torch.equal(q1, q1_p) and torch.equal(tot1, tot1_p)
    assert build(params, mask, cpu, backend="cuda").f_of(prog.init_state) is prog.init_state
    for budget in ("L2_INPLACE_BUDGET", "L2_INPLACE_BUDGET_I16"):
        monkeypatch.setattr(inplace_cuda, budget, inplace_cuda.state_bytes(16, 24, "i16"))
    assert build(params, mask, cpu, backend="cuda", storage="i16").variant == "cuda-inplace-i16"
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    assert build(params, mask, cpu, backend="cuda").variant == "cuda-step"  # f32 needs 2x
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET_I16",
                        inplace_cuda.state_bytes(16, 24, "i16") - 1)
    assert build(params, mask, cpu, backend="cuda", storage="i16").variant == "cuda-step-i16"
    with pytest.raises(ValueError, match="requires the cuda backend"):
        build(params, mask, cpu, backend="torch", storage="i16")
    with pytest.raises(ValueError, match="unknown storage"):
        build(params, mask, cpu, backend="cuda", storage="bf16")


def test_i16_wrappers_on_cpu_take_the_plain_version():
    params, mask = _scene(16, 24)
    obst = torch.from_numpy(mask)
    q0 = quant.quantize(_state(params, "mixed", "cpu"), params.density)
    counts = (LAUNCHES["K1-i16"], LAUNCHES["K3"], LAUNCHES["K3-i16"])
    q_p, tot_p = fused_torch.run_steps(q0, obst, params, 9, "i16")
    for run in (fused_cuda.make_run_all(params, obst, 9, "i16"),
                inplace_cuda.make_run_all(params, obst, 9, chunk=4, storage="i16")):
        q, tot = run(q0)
        assert torch.equal(q, q_p) and torch.equal(tot, tot_p)
    f0 = _state(params, "mixed", "cpu")
    f, tot = inplace_cuda.make_run_all(params, obst, 9, chunk=4)(f0)
    f_p, tot_p = fused_torch.run_steps(f0, obst, params, 9)
    assert torch.equal(f, f_p) and torch.equal(tot, tot_p)
    assert (LAUNCHES["K1-i16"], LAUNCHES["K3"], LAUNCHES["K3-i16"]) == counts
    q1, _ = fused_cuda.step(q0, obst, params, "i16")
    assert torch.equal(q1, fused_torch.fused_step_i16(q0, obst, params).f)


def test_kernel_times_report_i16():
    line = kernel_times.format_grid(128, {"K3-i16": (2.0, 1.5, 2.5)})
    assert line == "128^2: K3-i16 2.000 us/step [1.500, 2.500] 8192 MLUPS 303 GB/s"


def test_kernel_times_step_variants_and_card_paced_shard_line():
    """``--variant`` of step.cu (or of the header it includes) reaches the
    one-step kernels; the shard line carries the host- and card-paced
    K1-slab times side by side."""
    name, files, region = kernel_times.parse_variant("parent=build/parent/step.cu")
    assert (name, sorted(files), region) == ("parent", ["step.cu"], None)
    v = {n: kernel_times.Variant(None, None, frozenset(f)) for n, f in (
        ("k1", {"step.cu"}), ("common", {"lbm_common.cuh"}), ("k3", {"inplace.cu"}))}
    assert set(kernel_times.replacing(v, "step.cu")) == {"k1", "common"}
    assert set(kernel_times.replacing(v, "inplace.cu")) == {"k3", "common"}
    line = kernel_times.format_shard(1024, {"K1-slab-i16": (14.0, 13.5, 14.5),
                                            "K1-slab-i16 graph": (5.0, 4.75, 5.25),
                                            "K1-slab-i16@parent graph": (8.0, 7.5, 8.5)})
    assert line == ("1024^2/4 shard 256x1024: K1-slab-i16 14.000 us/step [13.500, 14.500] "
                    "18725 MLUPS | K1-slab-i16 graph 5.000 us/step [4.750, 5.250] 52429 MLUPS | "
                    "K1-slab-i16@parent graph 8.000 us/step [7.500, 8.500] 32768 MLUPS")


def test_build_flags_and_sources(tmp_path, monkeypatch):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert "-prec-div=true" in flags and "-prec-sqrt=true" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {s.name for s in _build.sources()} == {
        "step.cu", "resident.cu", "inplace.cu", "temporal.cu", "skew.cu", "ghosted.cu",
        "ca_resident.cu", "ca_inplace.cu", "hbm.cu", "blocked.cu", "l2_copy.cu",
        "cluster.cu", "smem_copy.cu", "lbm_common.cuh", "aa_inplace.cuh", "two_copy.cuh"}
    assert {"lbm_inplace_grid", "lbm_inplace_chunk", "lbm_step_run", "lbm_trapezoid_run",
            "lbm_skew_run", "lbm_slab_step", "lbm_ghosted_chunk", "lbm_trapezoid_slab",
            "lbm_ca_resident", "lbm_ca_inplace", "lbm_hbm_grid", "lbm_hbm_run",
            "lbm_blocked_grid", "lbm_blocked_chunk", "lbm_l2_copy_grid",
            "lbm_l2_copy"} <= set(_build._SIGNATURES)
    assert "lbm_hbm_sweep" not in _build._SIGNATURES  # PRs 5-13's K9: kernel_times only
    d0 = _build.build_dir()
    assert d0.parent == _build.BUILD_ROOT and len(d0.name) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.build_dir() != d0
    # No nvcc: the build raises, it does not fall back.
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = _smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
