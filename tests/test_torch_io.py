"""lbm_tpu_torch's numpy layer against lbm_tpu's: scene parsing, writers,
checker, lattice constants and the serial oracle must agree exactly."""

import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlattice
from lbm_tpu.core import oracle as joracle
from lbm_tpu.io import scene as jscene
from lbm_tpu.io import writers as jwriters
from lbm_tpu.tools import check as jcheck
from lbm_tpu_torch.core import lattice as tlattice
from lbm_tpu_torch.core import oracle as toracle
from lbm_tpu_torch.io import scene as tscene
from lbm_tpu_torch.io import writers as twriters
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import check as tcheck
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)


def _params(nx=32, ny=24, iters=12):
    return LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)


@pytest.mark.parametrize("preset", scenegen.PRESETS)
def test_scene_files_parse_identically(tmp_path, preset):
    pfile, ofile = scenegen.write_scene(str(tmp_path), preset, _params())
    tp, jp = tscene.load_params(pfile), jscene.load_params(pfile)
    assert (tp.nx, tp.ny, tp.max_iters, tp.reynolds_dim, tp.density, tp.accel, tp.omega) == (
        jp.nx, jp.ny, jp.max_iters, jp.reynolds_dim, jp.density, jp.accel, jp.omega)
    tm = tscene.load_obstacles(ofile, tp.nx, tp.ny)
    jm = jscene.load_obstacles(ofile, jp.nx, jp.ny)
    assert tm.dtype == jm.dtype == bool
    np.testing.assert_array_equal(tm, jm)
    assert tscene.load_scene(pfile, ofile).num_fluid_cells == jscene.load_scene(
        pfile, ofile).num_fluid_cells


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the comparison is of the exception itself
        return type(e).__name__, str(e), isinstance(e, ValueError)
    return None


@pytest.mark.parametrize(
    "line",
    ["5 0 1", "0 5 1", "-1 0 1", "1 1 2", "1 1", "1 1 1 1", "a 1 1", "\n\n2 2 1"],
    ids=["x-range", "y-range", "x-negative", "blocked!=1", "two-fields",
         "four-fields", "not-int", "blank-lines-ok"],
)
def test_obstacle_errors_match(tmp_path, line):
    p = tmp_path / "obstacles.dat"
    p.write_text(line + "\n")
    got = _raised(tscene.load_obstacles, p, 4, 4)
    want = _raised(jscene.load_obstacles, p, 4, 4)
    assert got == want
    if want is not None and want[0] == "SceneError":
        with pytest.raises(tscene.SceneError):
            tscene.load_obstacles(p, 4, 4)


@pytest.mark.parametrize(
    "text", ["128\n256\n", "128 256 10 10 0.1 x 1.85", "128 256 10 10 0.1 0.005 1.85 extra"],
    ids=["short", "not-number", "extra-field"],
)
def test_param_errors_match(tmp_path, text):
    p = tmp_path / "input.params"
    p.write_text(text)
    assert _raised(tscene.load_params, p) == _raised(jscene.load_params, p)


def test_missing_files_fail_alike(tmp_path):
    missing = tmp_path / "nope.dat"
    got = _raised(tscene.load_obstacles, missing, 4, 4)
    assert got is not None and got[0] == "FileNotFoundError"
    assert got == _raised(jscene.load_obstacles, missing, 4, 4)
    assert _raised(tscene.load_params, missing) == _raised(jscene.load_params, missing)


def _state(params, mask, steps=7):
    f, av = joracle.run(params, mask, num_steps=steps)
    return f, av


def test_writers_byte_identical(tmp_path):
    params = _params(nx=20, ny=12)
    mask = scenegen.make_mask("cylinder", params.ny, params.nx)
    f, av = _state(params, mask)
    twriters.write_final_state(tmp_path / "t_fs.dat", f, mask, params)
    jwriters.write_final_state(tmp_path / "j_fs.dat", f, mask, params)
    twriters.write_av_vels(tmp_path / "t_av.dat", av)
    jwriters.write_av_vels(tmp_path / "j_av.dat", av)
    assert (tmp_path / "t_fs.dat").read_bytes() == (tmp_path / "j_fs.dat").read_bytes()
    assert (tmp_path / "t_av.dat").read_bytes() == (tmp_path / "j_av.dat").read_bytes()
    np.testing.assert_array_equal(
        twriters.read_final_state(tmp_path / "t_fs.dat"),
        jwriters.read_final_state(tmp_path / "j_fs.dat"),
    )


def _check_outputs(tmp_path, params, mask, steps_a, steps_b, scale_b=1.0):
    fa, ava = _state(params, mask, steps_a)
    fb, avb = _state(params, mask, steps_b)
    fb = fb * np.float32(scale_b)
    for tag, f, av in (("a", fa, ava), ("b", fb, avb)):
        jwriters.write_final_state(tmp_path / f"{tag}_fs.dat", f, mask, params)
        jwriters.write_av_vels(tmp_path / f"{tag}_av.dat", av)
    return [
        "--ref-av-vels-file", str(tmp_path / "a_av.dat"),
        "--ref-final-state-file", str(tmp_path / "a_fs.dat"),
        "--av-vels-file", str(tmp_path / "b_av.dat"),
        "--final-state-file", str(tmp_path / "b_fs.dat"),
    ]


@pytest.mark.parametrize(
    "steps_b,scale_b,extra",
    [(6, 1.0, []), (6, 1.02, []), (5, 1.0, []), (6, 1.02, ["--tolerance", "5"])],
    ids=["pass", "fail-state", "step-count", "tolerance"],
)
def test_checker_matches(tmp_path, capsys, steps_b, scale_b, extra):
    params = _params(nx=16, ny=10)
    mask = scenegen.make_mask("cavity", params.ny, params.nx)
    argv = _check_outputs(tmp_path, params, mask, 6, steps_b, scale_b) + extra
    rc_t = tcheck.main(argv)
    out_t = capsys.readouterr().out
    rc_j = jcheck.main(argv)
    out_j = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    assert rc_t == (0 if (steps_b, scale_b) == (6, 1.0) or extra else 1)


def test_lattice_matches():
    for name in ("NSPEEDS", "CX", "CY", "OPP", "W0", "W1", "W2", "WEIGHTS", "C_SQ",
                 "UX_POS", "UX_NEG", "UY_POS", "UY_NEG"):
        assert getattr(tlattice, name) == getattr(jlattice, name), name
    np.testing.assert_array_equal(
        tlattice.equilibrium_rest(0.1, 5, 7), jlattice.equilibrium_rest(0.1, 5, 7))
    assert tlattice.accel_weights(0.1, 0.005) == jlattice.accel_weights(0.1, 0.005)
    dev = tlattice.equilibrium_rest_device(0.1, 5, 7, "cpu")
    assert dev.dtype == torch.float32 and dev.is_contiguous()
    np.testing.assert_array_equal(dev.numpy(), jlattice.equilibrium_rest(0.1, 5, 7))


def test_oracle_bitwise(small_params, small_obstacles):
    f_t, av_t = toracle.run(small_params, small_obstacles, num_steps=15)
    f_j, av_j = joracle.run(small_params, small_obstacles, num_steps=15)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(av_t, av_j)
    assert toracle.calc_reynolds(small_params, f_t, small_obstacles) == joracle.calc_reynolds(
        small_params, f_j, small_obstacles)
