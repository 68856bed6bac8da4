"""lbm_tpu_torch's ensemble (tools/ensemble.py, ops/ensemble_cuda.py, the
``sweep`` command) on the CPU, where the batched kernels K1-batch and
K2-batch run their plain version (``fused_torch.ensemble_step``).

- Instance b is bitwise a single twin run (``fused_torch.run_steps``) with
  b's omega and accel: the per-instance scalars enter the same float32
  operations, and each instance's |u| is summed over its own plane.
- Against ``lbm_tpu.tools.ensemble.run_ensemble`` on the same seeded numpy
  inputs the bounds are the twin's against ``fused_jnp``
  (tests/test_torch_step.py): XLA on the CPU contracts multiply-adds into
  FMAs and torch does not, so fields agree within atol 2e-7 and the av
  series within rtol 1e-4.
- ``sweep`` against ``lbm_tpu``'s on the same scene: the same header and
  columns, the same idx, omega and accel text, reynolds and final av within
  the av tolerance.

Bitwise equality of the kernels with the plain version is held on the card
(chip_smoke.py phase 3j, tools/verify_device.py)."""

import os
import sys

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu.tools import ensemble as jensemble
from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io import load_scene
from lbm_tpu_torch.ops import ensemble_cuda, fused_torch
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import ensemble, scenegen

torch.set_num_threads(1)


def _params(ny, nx, accel=0.005, omega=1.85):
    return LBMParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10, density=0.1, accel=accel,
                     omega=omega)


def _jparams(p):
    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                   density=p.density, accel=p.accel, omega=p.omega)


def _masks(ny, nx, geometry, seed=3):
    """(ny, nx) or (3, ny, nx): scenegen's cylinder, and for a geometry
    batch its cavity and a box with random interior walls."""
    rng = np.random.default_rng(seed)
    cyl = scenegen.make_mask("cylinder", ny, nx)
    if not geometry:
        return cyl
    walls = scenegen.make_mask("channel", ny, nx) | (rng.random((ny, nx)) < 0.05)
    walls[ny - 2, :] &= rng.random(nx) < 0.5  # keep some of the driven row fluid
    return np.stack([cyl, scenegen.make_mask("cavity", ny, nx), walls])


OMEGAS = np.asarray([0.6, 1.3, 1.95], dtype=np.float32)
# 1.0: the injection weights lie among a perturbed state's values, so the
# guard is true on some columns and false on others.
ACCELS = np.asarray([0.005, 1.0, 0.002], dtype=np.float32)


def _perturbed(B, ny, nx, seed=11):
    rng = np.random.default_rng(seed)
    rest = lattice.equilibrium_rest(0.1, ny, nx)
    return np.stack([rest * (np.float32(1.0) + rng.uniform(-0.1, 0.1, rest.shape).astype(
        np.float32)) for _ in range(B)])


def test_ensemble_weights_bitwise_accel_weights():
    accels = np.asarray([0.005, 0.01, 1.0, 0.002, 0.0173], dtype=np.float32)
    w1s, w2s = fused_torch.ensemble_weights(0.1, accels)
    for a, w1, w2 in zip(accels, w1s, w2s):
        e1, e2 = lattice.accel_weights(0.1, float(a))
        assert w1.tobytes() == np.float32(e1).tobytes() and w2.tobytes() == np.float32(
            e2).tobytes()


@pytest.mark.parametrize("geometry", [False, True], ids=["shared-mask", "geometry"])
def test_instance_is_bitwise_a_single_run(geometry):
    """run_ensemble(device="cpu") from rest, and the runner from a perturbed
    start with the guard split on the driven row: instance b's fields and
    tot_u (torch.equal) are those of run_steps with b's parameters."""
    ny, nx, steps = 32, 48, 30
    p = _params(ny, nx)
    masks = _masks(ny, nx, geometry)
    res = ensemble.run_ensemble(p, masks, OMEGAS, ACCELS, num_steps=steps, device="cpu")
    f0_b = torch.from_numpy(_perturbed(3, ny, nx))
    obst = torch.from_numpy(masks)
    run = ensemble_cuda.make_run_all(p, obst, OMEGAS, ACCELS, steps)
    assert run.kernel == "plain"
    f_b, tot_b = run(f0_b)
    w1s, _ = fused_torch.ensemble_weights(p.density, ACCELS)
    split = False
    for b in range(3):
        pb = p.replace(omega=float(OMEGAS[b]), accel=float(ACCELS[b]))
        ob = obst[b] if geometry else obst
        rest = lattice.equilibrium_rest_device(p.density, ny, nx, "cpu")
        f, tot = fused_torch.run_steps(rest, ob, pb, steps)
        assert torch.equal(torch.from_numpy(res.f[b]), f)
        av = tot.numpy() / np.float32((~ob).sum().item())
        assert np.array_equal(res.av_vels[:, b], av)
        f, tot = fused_torch.run_steps(f0_b[b], ob, pb, steps)
        assert torch.equal(f_b[b], f) and torch.equal(tot_b[:, b], tot)
        ok = (f0_b[b, 3, p.accel_row] - float(w1s[b]) > 0) & ~ob[p.accel_row]
        split = split or bool(ok.any() and not ok.all())
    assert split


def test_plain_scalar_omega_bitwise_python_float():
    """A (B, 1, 1) float32 omega tensor against the Python float the single
    step takes (exact in float32): the same bits."""
    ny, nx = 16, 24
    f0 = torch.from_numpy(_perturbed(1, ny, nx))
    obst = torch.from_numpy(scenegen.make_mask("cylinder", ny, nx))
    for omega in (0.6, 1.3, 1.85, 1.95):
        p = _params(ny, nx, omega=omega)
        f_b, _ = fused_torch.ensemble_step(f0, obst, torch.tensor([np.float32(omega)]),
                                           torch.tensor([fused_torch.step_constants(p)[1]]),
                                           torch.tensor([fused_torch.step_constants(p)[2]]),
                                           p.accel_row)
        assert torch.equal(f_b[0], fused_torch.fused_step_single(f0[0], obst, p).f)


@pytest.mark.parametrize("geometry", [False, True], ids=["shared-mask", "geometry"])
def test_port_matches_lbm_tpu_ensemble(geometry):
    ny, nx, steps = 32, 32, 40
    p = _params(ny, nx)
    masks = _masks(ny, nx, geometry)
    omegas, accels = OMEGAS[[1, 2, 0]], np.asarray([0.005, 0.01, 0.002], np.float32)
    mine = ensemble.run_ensemble(p, masks, omegas, accels, num_steps=steps, device="cpu")
    ref = jensemble.run_ensemble(_jparams(p), masks, omegas, accels, num_steps=steps)
    assert np.array_equal(mine.omegas, ref.omegas) and np.array_equal(mine.accels, ref.accels)
    assert mine.av_vels.shape == ref.av_vels.shape == (steps, 3)
    np.testing.assert_allclose(mine.f, ref.f, rtol=0, atol=2e-7)
    np.testing.assert_allclose(mine.av_vels, ref.av_vels, rtol=1e-4)
    np.testing.assert_allclose(mine.reynolds, ref.reynolds, rtol=1e-4)


def test_run_ensemble_validation_as_lbm_tpu():
    p = _params(16, 16)
    mask = scenegen.make_mask("cavity", 16, 16)
    cases = [
        (mask, [], None, "omegas must be a non-empty 1-D sequence"),
        (mask, [1.0, 1.5], [0.1], r"accels must have shape \(2,\), got \(1,\)"),
        (np.stack([mask] * 3), [1.0, 1.2], None,
         "obstacle batch of 3 masks does not match 2 parameter instances"),
    ]
    for obst, om, ac, msg in cases:
        for fn in (lambda: ensemble.run_ensemble(p, obst, om, ac, 2, device="cpu"),
                   lambda: jensemble.run_ensemble(_jparams(p), obst, om, ac, 2)):
            with pytest.raises(ValueError, match=msg):
                fn()
    # One omega broadcast over a geometry batch, and zero steps.
    res = ensemble.run_ensemble(p, np.stack([mask] * 2), 1.5, None, 0, device="cpu")
    ref = jensemble.run_ensemble(_jparams(p), np.stack([mask] * 2), 1.5, None, 0)
    assert res.av_vels.shape == ref.av_vels.shape == (0, 2)
    assert np.array_equal(res.reynolds, ref.reynolds)


def test_runner_refuses_what_the_kernels_do_not_take(monkeypatch):
    p = _params(16, 16)
    mask = torch.from_numpy(scenegen.make_mask("cavity", 16, 16))
    with pytest.raises(ValueError, match="unknown ensemble kernel"):
        ensemble_cuda.make_run_all(p, mask, [1.0], None, 2, kernel="K3-batch")
    with pytest.raises(ValueError, match="obstacle mask shape"):
        ensemble_cuda.make_run_all(p, mask[:8], [1.0], None, 2)
    run = ensemble_cuda.make_run_all(p, mask, [1.0, 1.2], None, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        run(torch.zeros((1, 9, 16, 16)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        ensemble.run_ensemble(p, mask.numpy(), [1.0], None, 2)


@pytest.mark.parametrize("spec,count", [("1.3:1.9:4", None), ("0.5:1.0:7", None),
                                        ("1.0,1.5,1.8", None), ("1.85", None), ("1.85", 5),
                                        ("0.01", 3), ("2:1:3", None), ("1:1:1", None)])
def test_parse_range_as_lbm_tpu(spec, count):
    mine, ref = ensemble.parse_range(spec, count), jensemble.parse_range(spec, count)
    assert mine.dtype == ref.dtype == np.float32 and np.array_equal(mine, ref)


@pytest.mark.parametrize("spec", ["1:2", "1:2:3:4", "a,b", "x", "1:2:z"])
def test_parse_range_refuses_as_lbm_tpu(spec):
    for fn in (ensemble.parse_range, jensemble.parse_range):
        with pytest.raises(ValueError):
            fn(spec)


@pytest.fixture(scope="module")
def sweep_scene(tmp_path_factory):
    """A 32x32 cylinder scene and two more geometries on its grid, and one
    obstacle file with a cell off the grid."""
    d = tmp_path_factory.mktemp("sweep_scene")
    p = _params(32, 32)
    pfile, ofile = scenegen.write_scene(str(d), "cylinder", p)
    geos = []
    for preset in ("cavity", "channel"):
        geos.append(scenegen.write_scene(str(d / preset), preset, p)[1])
    off = d / "off_grid.dat"
    off.write_text("5 5 1\n40 3 1\n")
    return pfile, ofile, geos, str(off)


def _sweep(main, args, out, capsys):
    rc = main(["sweep", *args, "--out-dir", str(out)])
    return rc, capsys.readouterr()


def _summary(path):
    lines = open(path).read().splitlines()
    return lines[0], [ln.split() for ln in lines[1:]]


@pytest.mark.parametrize("extra", [["--omega", "1.3:1.9:4"],
                                   ["--omega", "1.5", "--accel", "0.004,0.006,0.008"],
                                   ["--geometry", 0, "--geometry", 1]],
                         ids=["omega-range", "accel-list", "geometry"])
def test_sweep_cli_matches_lbm_tpu(sweep_scene, tmp_path, capsys, extra):
    pfile, ofile, geos, _ = sweep_scene
    extra = [geos[e] if isinstance(e, int) else e for e in extra]
    args = [pfile, ofile, *extra, "--steps", "30", "--av-vels"]
    rc, out = _sweep(cli.main, args + ["--device", "cpu"], tmp_path / "mine", capsys)
    assert rc == 0, out.err
    rc_ref, out_ref = _sweep(jcli.main, args + ["--platform", "cpu"], tmp_path / "ref", capsys)
    assert rc_ref == 0, out_ref.err
    assert out.out.replace(str(tmp_path / "mine"), "") == \
        out_ref.out.replace(str(tmp_path / "ref"), "")
    head, rows = _summary(tmp_path / "mine" / "sweep_summary.dat")
    head_ref, rows_ref = _summary(tmp_path / "ref" / "sweep_summary.dat")
    assert head == head_ref == "# idx omega accel reynolds final_av_velocity"
    assert len(rows) == len(rows_ref) >= 3
    for r, q in zip(rows, rows_ref):
        assert r[:3] == q[:3]
        np.testing.assert_allclose([float(v) for v in r[3:]], [float(v) for v in q[3:]],
                                   rtol=1e-4)
    B = len(rows)
    assert sorted(os.listdir(tmp_path / "mine")) == sorted(
        [f"av_vels_{i:03d}.dat" for i in range(B)] + ["sweep_summary.dat"])
    for i in range(B):
        mine = np.loadtxt(tmp_path / "mine" / f"av_vels_{i:03d}.dat", usecols=[1])
        ref = np.loadtxt(tmp_path / "ref" / f"av_vels_{i:03d}.dat", usecols=[1])
        assert mine.shape == (30,)
        np.testing.assert_allclose(mine, ref, rtol=1e-4)


def test_sweep_plot_writes_the_figure(sweep_scene, tmp_path, capsys):
    pfile, ofile, _, _ = sweep_scene
    rc, out = _sweep(cli.main, [pfile, ofile, "--omega", "1.3,1.6", "--steps", "5", "--plot",
                                "--device", "cpu", "--host-devices", "4"], tmp_path, capsys)
    assert rc == 0, out.err
    assert (tmp_path / "sweep.png").stat().st_size > 0
    assert out.out.strip().endswith("and sweep.png")


def test_sweep_zero_steps_writes_nan(sweep_scene, tmp_path, capsys):
    pfile, ofile, _, _ = sweep_scene
    rc, _ = _sweep(cli.main, [pfile, ofile, "--omega", "1.3,1.6", "--steps", "0",
                              "--device", "cpu"], tmp_path, capsys)
    assert rc == 0
    _, rows = _summary(tmp_path / "sweep_summary.dat")
    assert [r[4] for r in rows] == ["NAN", "NAN"]


def test_sweep_error_paths(sweep_scene, tmp_path, capsys, monkeypatch):
    pfile, ofile, geos, off = sweep_scene
    cases = [
        [pfile, ofile, "--omega", "1.0,1.2", "--accel", "0.1,0.2,0.3", "--device", "cpu"],
        [pfile, ofile, "--geometry", off, "--device", "cpu"],
        [pfile, ofile, "--geometry", geos[0], "--omega", "1.0,1.2,1.4", "--device", "cpu"],
    ]
    for args in cases:
        rc, out = _sweep(cli.main, args, tmp_path / "o", capsys)
        assert rc == 1 and out.err.startswith("Error:"), out.err
    assert "--omega has 2 values but the sweep has 3 instances" in _sweep(
        cli.main, cases[0], tmp_path / "o", capsys)[1].err
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc, out = _sweep(cli.main, [pfile, ofile, "--plot", "--device", "cpu"], tmp_path / "p",
                     capsys)
    assert rc == 1 and out.err.startswith("Error:") and "matplotlib" in out.err
    assert not (tmp_path / "p").exists()
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _sweep(cli.main, [pfile, ofile, "--device", "cuda"], tmp_path / "c", capsys)
    assert rc == 1 and out.err.strip() == "Error: no CUDA device"
    rc, out = _sweep(cli.main, [pfile, ofile], tmp_path / "c", capsys)
    assert rc == 1 and out.err.strip() == "Error: no CUDA device"
    assert not (tmp_path / "c").exists()


def test_sweep_geometry_reads_files_against_the_base_grid(sweep_scene):
    pfile, ofile, geos, _ = sweep_scene
    scene = load_scene(pfile, ofile)
    assert load_scene(pfile, geos[0]).obstacles.shape == scene.obstacles.shape
