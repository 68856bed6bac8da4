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
from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, inplace_cuda, quant, resident_cuda
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
    before = fused_cuda.LAUNCHES
    f_k, tot_k = fused_cuda.make_run_all(params, obst, 20)(f0)
    assert fused_cuda.LAUNCHES == before + 20
    f_p, tot_p = fused_cuda.run_plain(f0, obst, params, 20)
    _assert_matches(f_k, tot_k, f_p, tot_p)
    one, tot_one = fused_cuda.step(f0, obst, params)
    f_1, tot_1 = fused_cuda.step_plain(f0, obst, params)
    _assert_matches(one, tot_one.reshape(1), f_1, tot_1.reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 4), (5, 8), (40, 16)])
def test_k2_matches_plain_on_card(cuda_device, steps, chunk, kind):
    params, mask = _scene(32, 64)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _state(params, kind, cuda_device)
    before = resident_cuda.LAUNCHES
    f_k, tot_k = resident_cuda.make_run_all(params, obst, steps, chunk=chunk)(f0)
    assert resident_cuda.LAUNCHES == before + -(-steps // chunk)
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
    counter = "LAUNCHES_I16" if storage == "i16" else "LAUNCHES"
    before = getattr(inplace_cuda, counter)
    run = inplace_cuda.make_run_all(params, obst, steps, chunk=chunk, storage=storage)
    f_k, tot_k = run(f0)
    assert getattr(inplace_cuda, counter) == before + -(-steps // chunk)
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
    before = fused_cuda.LAUNCHES_I16
    q_k, tot_k = fused_cuda.make_run_all(params, obst, 20, "i16")(q0)
    assert fused_cuda.LAUNCHES_I16 == before + 20
    q_p, tot_p = fused_cuda.run_plain(q0, obst, params, 20, "i16")
    assert q_k.dtype == torch.int16
    _assert_matches(q_k, tot_k, q_p, tot_p)


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
    k1, k2 = fused_cuda.LAUNCHES, resident_cuda.LAUNCHES
    f_p, tot_p = fused_torch.run_steps(f0, obst, params, 9)
    for run in (fused_cuda.make_run_all(params, obst, 9),
                resident_cuda.make_run_all(params, obst, 9, chunk=4)):
        f, tot = run(f0)
        assert torch.equal(f, f_p) and torch.equal(tot, tot_p)
    f1, tot1 = fused_cuda.step(f0, obst, params)
    f1_p, tot1_p = fused_torch.fused_step_single(f0, obst, params)
    assert torch.equal(f1, f1_p) and torch.equal(tot1, tot1_p)
    assert (fused_cuda.LAUNCHES, resident_cuda.LAUNCHES) == (k1, k2)
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
    counts = (fused_cuda.LAUNCHES_I16, inplace_cuda.LAUNCHES, inplace_cuda.LAUNCHES_I16)
    q_p, tot_p = fused_torch.run_steps(q0, obst, params, 9, "i16")
    for run in (fused_cuda.make_run_all(params, obst, 9, "i16"),
                inplace_cuda.make_run_all(params, obst, 9, chunk=4, storage="i16")):
        q, tot = run(q0)
        assert torch.equal(q, q_p) and torch.equal(tot, tot_p)
    f0 = _state(params, "mixed", "cpu")
    f, tot = inplace_cuda.make_run_all(params, obst, 9, chunk=4)(f0)
    f_p, tot_p = fused_torch.run_steps(f0, obst, params, 9)
    assert torch.equal(f, f_p) and torch.equal(tot, tot_p)
    assert (fused_cuda.LAUNCHES_I16, inplace_cuda.LAUNCHES, inplace_cuda.LAUNCHES_I16) == counts
    q1, _ = fused_cuda.step(q0, obst, params, "i16")
    assert torch.equal(q1, fused_torch.fused_step_i16(q0, obst, params).f)


def test_kernel_times_report_i16():
    line = kernel_times.format_grid(128, {"K3-i16": (2.0, 1.5, 2.5)})
    assert line == "128^2: K3-i16 2.000 us/step [1.500, 2.500] 8192 MLUPS 303 GB/s"


def test_build_flags_and_sources(tmp_path, monkeypatch):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert "-prec-div=true" in flags and "-prec-sqrt=true" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {s.name for s in _build.sources()} == {
        "step.cu", "resident.cu", "inplace.cu", "temporal.cu", "skew.cu", "ghosted.cu",
        "ca_resident.cu", "ca_inplace.cu", "blocked.cu", "lbm_common.cuh"}
    assert {"lbm_inplace_grid", "lbm_inplace_chunk", "lbm_step_run", "lbm_trapezoid_run",
            "lbm_skew_run", "lbm_slab_step", "lbm_ghosted_chunk", "lbm_trapezoid_slab",
            "lbm_ca_resident", "lbm_ca_inplace", "lbm_hbm_sweep", "lbm_blocked_grid",
            "lbm_blocked_chunk"} <= set(_build._SIGNATURES)
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
