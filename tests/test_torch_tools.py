"""lbm_tpu_torch's tools against lbm_tpu's, on the CPU: the divergence
probe, ``golden``, and the matplotlib commands ``viz``, ``animate`` and
``speedup`` (as tests/test_tools.py checks lbm_tpu's)."""

import filecmp
import json
import sys
import warnings

import numpy as np
import pytest
import torch

from lbm_tpu.io.scene import Scene as JScene
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu.tools import divergence as jdivergence
from lbm_tpu_torch import cli
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.parallel import mesh as mesh_lib
from lbm_tpu_torch.parallel import modes
from lbm_tpu_torch.tools import divergence, scenegen


def _box(ny=32, nx=64, steps=40):
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[10:12, 30:32] = True
    return Scene(params, mask)


def test_divergence_matches_lbm_tpu():
    """Two shards, staleness 1, 40 steps, against lbm_tpu's run_divergence
    (its jnp step).  Tolerances from the FMA note (ROADMAP queue C): XLA on
    the CPU contracts multiply-adds and torch does not, so fields differ by
    up to 2e-7 and av by 1e-4 relative.  The series are differences of
    two such fields: each |f_s - f_a| moves by at most 2 x 2e-7, so rms by
    at most 4e-7 and the relative L-infinity norm by 4e-7 / max|f_s|
    (~0.04 here), under 1e-5."""
    scene = _box()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 2 shards over 32 rows: the stale-row warning
        res = divergence.run_divergence(scene, num_devices=2, staleness=1, device="cpu",
                                        host_devices=2)
    p = scene.params
    jp = JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                 density=p.density, accel=p.accel, omega=p.omega)
    ref = jdivergence.run_divergence(JScene(jp, scene.obstacles), num_devices=2, staleness=1)
    assert (res.mode, res.staleness, res.num_devices) == ("async", 1, 2)
    for key in ("av_sync", "av_async", "field_rel_linf", "field_rms"):
        assert getattr(res, key).shape == (40,) and getattr(res, key).dtype == np.float32
    np.testing.assert_allclose(res.av_sync, ref.av_sync, rtol=1e-4)
    np.testing.assert_allclose(res.av_async, ref.av_async, rtol=1e-4)
    np.testing.assert_allclose(res.field_rel_linf, ref.field_rel_linf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.field_rms, ref.field_rms, rtol=0, atol=4e-7)
    assert res.field_rel_linf[-1] > 0  # the stale halos did move the field
    with pytest.raises(ValueError, match="stale-halo"):
        divergence.run_divergence(scene, mode="sync", device="cpu")


def test_divergence_series_equal_the_formula_on_the_gathered_fields():
    """The series combined from per-shard partials in shard order equal the
    direct formula on ``f_of``'s fields (max|d| / max|f_s| and
    sqrt(mean(d^2)) over the real grid): the max-based column exactly, the
    rms at rtol 1e-6.  The scene has open seams and ny = 30 over 4 shards,
    so the last shard carries 2 padding rows, which a partial must leave
    out (counted, the rms moves by far more than 1e-6)."""
    ny, nx, steps = 30, 40, 12
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[:, 0] = mask[:, -1] = True
    mask[12:15, 18:21] = True
    scene = Scene(params, mask)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the stale-row warning
        res = divergence.run_divergence(scene, staleness=2, device="cpu", host_devices=4)
        mesh = mesh_lib.run_mesh(None, "cpu", 4)
        assert modes.open_seam_pad(mask, mesh.size) == 2
        progs = [modes.build_sharded_program(params, mask, mesh, mode=m, staleness=k)
                 for m, k in (("sync", 1), ("async", 2))]
    runs = [p.make_run_all(1) for p in progs]
    states = [p.init_state for p in progs]
    linf, rms = [], []
    for _ in range(steps):
        states = [run(st)[0] for run, st in zip(runs, states)]
        fs, fa = (p.f_of(st) for p, st in zip(progs, states))
        assert fs.shape == (9, ny, nx)
        d = (fs - fa).abs()
        linf.append(float(d.max() / fs.abs().max()))
        rms.append(float(torch.sqrt(torch.mean(d * d))))
    assert res.field_rel_linf[-1] > 0
    np.testing.assert_array_equal(res.field_rel_linf, np.float32(linf))
    np.testing.assert_allclose(res.field_rms, np.float32(rms), rtol=1e-6, atol=0)


def test_cli_divergence_csv(tmp_path, capsys):
    """``run --divergence`` writes lbm_tpu's columns, one row a step; its
    av_sync column is the sync run's av_vels.dat at the printed digits."""
    params = LBMParams(nx=64, ny=32, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    common = ["--platform", "cpu", "--host-devices", "2", "--steps", "30"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(["run", pfile, ofile, *common, "--divergence",
                         "--out-dir", str(tmp_path / "d")]) == 0
        assert cli.main(["run", pfile, ofile, *common, "--variant", "sync",
                         "--out-dir", str(tmp_path / "s")]) == 0
    out = capsys.readouterr().out
    assert "divergence over 30 steps (async, staleness=1, 2 shards)" in out
    lines = (tmp_path / "d" / "divergence.csv").read_text().splitlines()
    assert lines[0] == "step,av_sync,av_async,av_rel_pct,field_rel_linf,field_rms"
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    assert rows.shape == (30, 6) and np.array_equal(rows[:, 0], np.arange(30))
    av = np.loadtxt(tmp_path / "s" / "av_vels.dat", usecols=[1])
    np.testing.assert_array_equal(rows[:, 1].astype(np.float32), av.astype(np.float32))


def test_cli_golden_writes_the_runs_files(tmp_path, capsys):
    params = LBMParams(nx=48, ny=24, max_iters=25, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    assert cli.main(["golden", pfile, ofile, "--platform", "cpu",
                     "--out-dir", str(tmp_path / "g")]) == 0
    assert "variant=torch" in capsys.readouterr().out
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "torch",
                     "--out-dir", str(tmp_path / "r")]) == 0
    for name, gold in (("av_vels.dat", "48x24.av_vels.dat"),
                       ("final_state.dat", "48x24.final_state.dat")):
        assert filecmp.cmp(tmp_path / "r" / name, tmp_path / "g" / gold, shallow=False)


def test_cli_viz_animate_speedup_write_files(tmp_path, capsys):
    params = LBMParams(nx=32, ny=16, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--frame-interval", "5",
                     "--out-dir", str(tmp_path / "o")]) == 0
    assert cli.main(["viz", str(tmp_path / "o" / "final_state.dat"),
                     "--output", str(tmp_path / "fs.png")]) == 0
    assert (tmp_path / "fs.png").stat().st_size > 1000
    assert cli.main(["animate", str(tmp_path / "o" / "animation_data"), "--output",
                     str(tmp_path / "a.gif"), "--preview"]) == 0
    assert (tmp_path / "a.gif").stat().st_size > 100
    assert (tmp_path / "a_preview.gif").stat().st_size > 100
    assert cli.main(["bench", "--grid", "16x16", "--steps", "4", "--repeats", "1",
                     "--platform", "cpu"]) == 0
    report = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(report)["device"] == "cpu"
    (tmp_path / "r.jsonl").write_text(report + "\n" + json.dumps(
        {"grid": "1024x1024", "value": 50000.0, "device": "cpu"}) + "\n")
    assert cli.main(["speedup", str(tmp_path / "r.jsonl"), "--output",
                     str(tmp_path / "s.png")]) == 0
    assert (tmp_path / "s.png").stat().st_size > 1000


@pytest.mark.parametrize("command", ["viz", "animate", "golden", "speedup"])
def test_cli_tool_commands_exit_1_on_errors(tmp_path, capsys, monkeypatch, command):
    """The commands once refused are ported: a missing input exits 1 with
    ``Error:``, never argparse's 2; without matplotlib, viz, animate and
    speedup exit 1 saying so (the card's machine has none)."""
    missing = str(tmp_path / "missing")
    argv = {"viz": [missing], "animate": [missing], "speedup": [missing],
            "golden": [missing, missing, "--platform", "cpu"]}[command]
    assert cli.main([command, *argv]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error:") and "not yet ported" not in err
    if command != "golden":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        assert cli.main([command, *argv]) == 1
        assert capsys.readouterr().err.strip() == (
            f"Error: {command} needs matplotlib, which is not installed")
