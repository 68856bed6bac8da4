"""lbm_tpu_torch's driver and CLI against lbm_tpu's, on the CPU.

Tolerances as in tests/test_torch_step.py: fields atol 2e-7 and av rtol 1e-4
against lbm_tpu's jnp runs (XLA's FMA contraction on the CPU); bitwise where
both sides run the same code (serial oracle, segmented vs unsegmented)."""

import filecmp
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu.io.scene import Scene as JScene
from lbm_tpu.models import driver as jdriver
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu_torch import cli
from lbm_tpu_torch.io import state as tstate
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.io.writers import read_av_vels
from lbm_tpu_torch.models import driver
from lbm_tpu_torch.models.variants import resolve_variant
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import bench, scenegen

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _scene(ny, nx, steps=50):
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + 2, nx // 2: nx // 2 + 2] = True
    return Scene(params, mask)


def _jscene(scene):
    p = scene.params
    return JScene(JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters,
                          reynolds_dim=p.reynolds_dim, density=p.density,
                          accel=p.accel, omega=p.omega), scene.obstacles)


def _cpu(variant, **kw):
    return driver.RunConfig(variant=variant, device="cpu", **kw)


@pytest.mark.parametrize("variant", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(16, 16), (32, 128)], ids=["16x16", "32x128"])
def test_run_matches_lbm_tpu_jnp(shape, variant):
    """``cuda`` on the CPU runs the kernels' plain versions through the same
    program (K2's for these grids)."""
    scene = _scene(*shape)
    res = driver.run_simulation(scene, _cpu(variant))
    ref = jdriver.run_simulation(_jscene(scene), jdriver.RunConfig(variant="jnp"))
    assert res.f.shape == ref.f.shape and res.av_vels.shape == (50,)
    assert res.variant == ("torch" if variant == "torch" else "cuda-resident")
    np.testing.assert_allclose(res.f, ref.f, atol=2e-7)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)
    assert res.reynolds == pytest.approx(ref.reynolds, rel=1e-4)
    assert np.isfinite(res.mlups) and res.device == "cpu"


@pytest.mark.parametrize("variant", ["torch", "cuda"])
def test_segmented_equals_unsegmented(variant):
    scene = _scene(16, 24, steps=30)
    whole = driver.run_simulation(scene, _cpu(variant, segment_steps=0))
    parts = driver.run_simulation(scene, _cpu(variant, segment_steps=7))
    assert driver._segment_lengths(30, _cpu(variant, segment_steps=7)) == [7, 7, 7, 7, 2]
    np.testing.assert_array_equal(parts.f, whole.f)
    np.testing.assert_array_equal(parts.av_vels, whole.av_vels)


def test_segment_lengths_default():
    cfg = _cpu("torch")
    assert driver._segment_lengths(4000, cfg) is None
    assert driver._segment_lengths(8000, cfg) == [4000, 4000]
    assert driver._segment_lengths(10000, cfg) == [4000, 4000, 2000]


def test_serial_bitwise_equal_to_lbm_tpu(small_obstacles):
    scene = _scene(16, 16, steps=25)
    scene = Scene(scene.params, small_obstacles)
    res = driver.run_simulation(scene, _cpu("serial"))
    ref = jdriver.run_simulation(_jscene(scene), jdriver.RunConfig(variant="serial"))
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_array_equal(res.av_vels, ref.av_vels)
    assert res.reynolds == ref.reynolds


@pytest.mark.parametrize("variant", ["torch", "cuda"])
def test_continue_a_lbm_tpu_checkpoint(tmp_path, variant):
    """lbm_tpu runs 30 steps and checkpoints; the port loads the checkpoint,
    takes the state over and runs 20 more; the result matches lbm_tpu's
    50-step run."""
    scene = _scene(32, 64, steps=50)
    js = _jscene(scene)
    jdriver.run_simulation(js, jdriver.RunConfig(
        variant="jnp", num_steps=30, checkpoint_every=30, checkpoint_dir=str(tmp_path)))
    ck = tstate.load_reference_checkpoint(tmp_path / "ckpt_00000030.npz")
    assert ck.step == 30 and ck.av_vels.shape == (30,) and ck.f.dtype == np.float32
    f0, obst = tstate.from_reference(ck.f, scene.obstacles, "cpu")
    assert f0.dtype == torch.float32 and obst.dtype == torch.bool
    np.testing.assert_array_equal(obst.numpy(), scene.obstacles)
    res = driver.run_simulation(scene, _cpu(variant, num_steps=20), f0=f0)
    ref = jdriver.run_simulation(js, jdriver.RunConfig(variant="jnp", num_steps=50))
    np.testing.assert_allclose(res.f, ref.f, atol=2e-7)
    np.testing.assert_allclose(np.concatenate([ck.av_vels, res.av_vels]), ref.av_vels,
                               rtol=1e-4)


def test_from_reference_validates():
    mask = np.zeros((4, 5), dtype=bool)
    with pytest.raises(ValueError):
        tstate.from_reference(np.zeros((9, 5, 4), np.float32), mask, "cpu")
    with pytest.raises(ValueError):
        tstate.from_reference(np.zeros((9, 4, 5), np.float64), mask, "cpu")


def test_variants_resolve():
    assert resolve_variant("auto") == "auto"
    assert resolve_variant("jnp") == "torch"
    assert resolve_variant("PALLAS") == "cuda"
    assert resolve_variant("serial") == "serial"
    assert resolve_variant("sync") == "sync" and resolve_variant("mpi") == "sync"
    assert resolve_variant("ca") == "ca"
    with pytest.raises(ValueError, match="unknown variant"):
        resolve_variant("bogus")
    assert driver.pick_variant("auto", torch.device("cpu")) == "torch"
    assert driver.pick_variant("auto", torch.device("cuda", 0)) == "cuda"


@pytest.fixture
def scene_files(tmp_path):
    params = LBMParams(nx=24, ny=16, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    return scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)


@pytest.mark.parametrize("variant", ["auto", "torch", "cuda", "jnp", "pallas", "serial"])
def test_cli_run_and_check(tmp_path, scene_files, capsys, variant):
    pfile, ofile = scene_files
    out = tmp_path / "out"
    rc = cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", variant,
                   "--out-dir", str(out)])
    captured = capsys.readouterr().out
    assert rc == 0
    assert "==done==" in captured and "Reynolds number:" in captured
    assert "Elapsed Compute time:" in captured and "MLUPS" in captured
    assert len(read_av_vels(out / "av_vels.dat")) == 20
    assert (out / "final_state.dat").exists()
    rc = cli.main([
        "check",
        "--ref-av-vels-file", str(out / "av_vels.dat"),
        "--ref-final-state-file", str(out / "final_state.dat"),
        "--av-vels-file", str(out / "av_vels.dat"),
        "--final-state-file", str(out / "final_state.dat"),
    ])
    assert rc == 0 and "Both tests passed!" in capsys.readouterr().out


def test_cli_outputs_match_lbm_tpu(tmp_path, scene_files, capsys):
    """The port's files pass lbm_tpu's own checker against lbm_tpu's run."""
    from lbm_tpu.cli import main as jmain

    pfile, ofile = scene_files
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    assert jmain(["run", pfile, ofile, "--variant", "jnp", "--out-dir", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    rc = jmain([
        "check",
        "--ref-av-vels-file", str(tmp_path / "j" / "av_vels.dat"),
        "--ref-final-state-file", str(tmp_path / "j" / "final_state.dat"),
        "--av-vels-file", str(tmp_path / "t" / "av_vels.dat"),
        "--final-state-file", str(tmp_path / "t" / "final_state.dat"),
    ])
    assert rc == 0 and "Both tests passed!" in capsys.readouterr().out


@pytest.mark.parametrize(
    "command,extra,says",
    [("run", ["--platform", "tpu"], "the TPU is lbm_tpu's platform"),
     ("bench", ["--platform", "tpu"], "the TPU is lbm_tpu's platform"),
     ("info", ["--platform", "tpu"], "the TPU is lbm_tpu's platform"),
     ("info", ["--probe"], "info --probe is TPU-only; not ported to lbm_tpu_torch")],
    ids=lambda a: " ".join(a) if isinstance(a, list) else None,
)
def test_cli_unported_flags_exit_1(tmp_path, scene_files, capsys, command, extra, says):
    """The refusals left: lbm_tpu's TPU platform and its TPU tunnel probe
    exit 1 with ``Error: ...``, not argparse's 2, and write nothing."""
    pfile, ofile = scene_files
    out = tmp_path / "out"
    argv = {"run": ["run", pfile, ofile, "--out-dir", str(out)],
            "bench": ["bench", "--grid", "16x16", "--steps", "2"], "info": ["info"]}[command]
    rc = cli.main(argv + extra)
    err = capsys.readouterr().err
    assert rc == 1
    assert err.startswith("Error:") and says in err
    assert not out.exists()


def test_cli_platform_is_the_device(tmp_path, scene_files, capsys):
    """``--platform cpu`` runs as ``--device cpu``, byte for byte; with
    ``--host-devices 2`` it runs 2 shards of the CPU; a platform that
    contradicts ``--device`` exits 1."""
    pfile, ofile = scene_files
    runs = {"device": ["--device", "cpu"], "platform": ["--platform", "cpu"],
            "both": ["--platform", "CPU", "--device", "cpu"],
            "shards": ["--platform", "cpu", "--host-devices", "2", "--variant", "sync"]}
    for tag, extra in runs.items():
        assert cli.main(["run", pfile, ofile, "--out-dir", str(tmp_path / tag), *extra]) == 0
        for name in ("final_state.dat", "av_vels.dat"):
            if tag != "shards":  # sync's av_vels sums |u| per shard
                assert filecmp.cmp(tmp_path / tag / name, tmp_path / "device" / name,
                                   shallow=False), (tag, name)
    assert filecmp.cmp(tmp_path / "shards" / "final_state.dat",
                       tmp_path / "device" / "final_state.dat", shallow=False)
    out = capsys.readouterr().out
    assert "lbm_tpu_torch: device=cpu" in out and "Variant:\t\t\tsync\n" in out
    assert cli.main(["run", pfile, ofile, "--platform", "cpu", "--host-devices", "2",
                     "--variant", "sync", "--plan"]) == 0
    assert "shards: 2 x 8 rows (one device, cpu)" in capsys.readouterr().out
    assert cli.main(["run", pfile, ofile, "--platform", "gpu", "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == "Error: --platform gpu contradicts --device cpu"


def test_cli_profile_writes_a_trace_and_the_same_files(tmp_path, scene_files, capsys):
    """``--profile DIR`` writes a Chrome trace of the compute bracket, its
    ``lbm.compute`` range included, and leaves the outputs byte-identical
    to the unprofiled run's."""
    pfile, ofile = scene_files
    base = ["run", pfile, ofile, "--device", "cpu", "--variant", "cuda", "--steps", "6"]
    assert cli.main(base + ["--out-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(base + ["--out-dir", str(tmp_path / "prof"),
                            "--profile", str(tmp_path / "trace")]) == 0
    out = capsys.readouterr().out
    assert f"trace {tmp_path / 'trace' / 'trace.json'}" in out
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "lbm.compute" in {e["name"] for e in trace["traceEvents"]
                             if e.get("cat") == "user_annotation"}
    for name in ("final_state.dat", "av_vels.dat"):
        assert filecmp.cmp(tmp_path / "plain" / name, tmp_path / "prof" / name, shallow=False)
    res = driver.run_simulation(_scene(16, 16, steps=4), _cpu(
        "torch", profile_dir=str(tmp_path / "t2")))
    assert res.profile["trace"] == str(tmp_path / "t2" / "trace.json")
    assert res.profile["kernel_events"] == 0 and res.profile["busy_share"] is None


class _FakeProfiler:
    """Writes a fixed Chrome trace, as torch.profiler's export does."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as fp:
            json.dump({"traceEvents": self.events}, fp)


def test_profile_summary_reads_the_kernel_events(tmp_path):
    """Kernel events (``cat: kernel``) are counted and timed per name, their
    union over the bracket is the busy share; on a CUDA run a trace with no
    kernel event is an error, on the CPU it is the expected trace."""
    events = [{"cat": "kernel", "ph": "X", "name": "k_a", "ts": 0.0, "dur": 4.0},
              {"cat": "kernel", "ph": "X", "name": "k_b", "ts": 2.0, "dur": 4.0},
              {"cat": "kernel", "ph": "X", "name": "k_a", "ts": 10.0, "dur": 2.0},
              {"cat": "cpu_op", "ph": "X", "name": "aten::add", "ts": 0.0, "dur": 50.0}]
    got = driver._profile_summary(_FakeProfiler(events), str(tmp_path / "t"),
                                  torch.device("cuda", 0), 16e-6)
    assert got["trace"] == str(tmp_path / "t" / "trace.json") and got["kernel_events"] == 3
    assert got["kernels"] == {"k_a": {"launches": 2, "us": 6.0}, "k_b": {"launches": 1, "us": 4.0}}
    assert got["busy_s"] == pytest.approx(8e-6) and got["busy_share"] == pytest.approx(0.5)
    cpu_only = [e for e in events if e["cat"] != "kernel"]
    with pytest.raises(ValueError, match="holds no CUDA kernel event"):
        driver._profile_summary(_FakeProfiler(cpu_only), str(tmp_path / "u"),
                                torch.device("cuda", 0), 1.0)
    got = driver._profile_summary(_FakeProfiler(cpu_only), str(tmp_path / "v"),
                                  torch.device("cpu"), 1.0)
    assert got["kernel_events"] == 0 and got["busy_share"] is None


def test_busy_seconds_is_the_union_of_intervals():
    assert driver._busy_seconds([(0.0, 10.0), (5.0, 12.0), (20.0, 21.0)]) == pytest.approx(13e-6)
    assert driver._busy_seconds([]) == 0.0


def test_cli_run_takes_every_lbm_tpu_run_flag():
    """Every option of lbm_tpu's ``run`` is an option of the port's."""
    import argparse

    from lbm_tpu import cli as jcli

    def options(add):
        p = argparse.ArgumentParser()
        add(p)
        return {o for a in p._actions for o in a.option_strings}

    assert options(jcli._add_run_args) <= options(cli._add_run_args)


def test_cli_bench_and_info_take_lbm_tpus_flags(capsys):
    """C3: ``bench --platform cpu`` and ``info --host-devices 2`` ran into
    argparse's exit 2; every flag of lbm_tpu's bench and info parses."""
    assert cli.main(["bench", "--grid", "16x16", "--steps", "3", "--repeats", "1",
                     "--platform", "cpu", "--host-devices", "2", "--variant", "sync"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu" and report["variant"] == "sync"
    assert cli.main(["info", "--host-devices", "2"]) == 0
    assert cli.main(["info", "--platform", "cpu", "--host-devices", "2"]) == 0
    assert "run devices: 2 shards of cpu" in capsys.readouterr().out


@pytest.mark.parametrize("variant", ["torch", "jnp", "serial"])
def test_cli_i16_needs_the_cuda_variant(tmp_path, scene_files, capsys, variant):
    pfile, ofile = scene_files
    out = tmp_path / "out"
    rc = cli.main(["run", pfile, ofile, "--device", "cpu", "--storage", "i16",
                   "--variant", variant, "--out-dir", str(out)])
    err = capsys.readouterr().err
    assert rc == 1 and err.startswith("Error:") and "storage 'i16'" in err
    assert not out.exists()


def test_cli_i16_run_passes_check_against_f32(tmp_path, capsys):
    """``run --storage i16`` on the CPU (the cuda variant's plain versions)
    writes files that pass ``check`` against the same run in f32."""
    params = LBMParams(nx=64, ny=32, max_iters=200, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    for storage in ("f32", "i16"):
        rc = cli.main(["run", pfile, ofile, "--device", "cpu", "--storage", storage,
                       "--steps", "200", "--out-dir", str(tmp_path / storage)])
        out = capsys.readouterr().out
        assert rc == 0
        want = "cuda-inplace-i16" if storage == "i16" else "torch"
        assert f"Variant:\t\t\t{want}" in out
    rc = cli.main([
        "check",
        "--ref-av-vels-file", str(tmp_path / "f32" / "av_vels.dat"),
        "--ref-final-state-file", str(tmp_path / "f32" / "final_state.dat"),
        "--av-vels-file", str(tmp_path / "i16" / "av_vels.dat"),
        "--final-state-file", str(tmp_path / "i16" / "final_state.dat"),
    ])
    assert rc == 0 and "Both tests passed!" in capsys.readouterr().out


def test_i16_run_matches_f32_run():
    """30 steps on a 16x128 box: the quantized run tracks the exact one to
    quantization noise (the bounds of tests/test_quant.py:74-86)."""
    params = LBMParams(nx=128, ny=16, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((16, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    scene = Scene(params, mask)
    ref = driver.run_simulation(scene, _cpu("torch"))
    res = driver.run_simulation(scene, _cpu("auto", storage="i16"))
    assert res.variant == "cuda-inplace-i16"
    assert res.f.dtype == np.float32  # f_of dequantizes
    assert np.abs(res.f - ref.f).max() / np.abs(ref.f).max() < 5e-4
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-2)


def test_i16_segmented_equals_unsegmented():
    scene = _scene(16, 24, steps=30)
    whole = driver.run_simulation(scene, _cpu("cuda", segment_steps=0, storage="i16"))
    parts = driver.run_simulation(scene, _cpu("cuda", segment_steps=7, storage="i16"))
    np.testing.assert_array_equal(parts.f, whole.f)
    np.testing.assert_array_equal(parts.av_vels, whole.av_vels)
    with pytest.raises(ValueError, match="unknown storage"):
        driver.run_simulation(scene, _cpu("cuda", storage="bf16"))


def test_cli_bench_i16(capsys):
    assert cli.main(["bench", "--grid", "16x16", "--steps", "5", "--repeats", "1",
                     "--device", "cpu", "--storage", "i16"]) == 0
    import json

    report = json.loads(capsys.readouterr().out)
    assert report["storage"] == "i16" and report["variant"] == "cuda-inplace-i16"
    assert report["metric"] == "MLUPS 16x16 cuda-inplace-i16" and report["device"] == "cpu"


def test_cli_error_paths(tmp_path, scene_files, capsys):
    pfile, ofile = scene_files
    bad = tmp_path / "bad.dat"
    bad.write_text("0 99 1\n")
    assert cli.main(["run", pfile, str(bad), "--device", "cpu"]) == 1
    assert "Error:" in capsys.readouterr().err
    assert cli.main(["run", str(tmp_path / "missing.params"), ofile, "--device", "cpu"]) == 1
    assert capsys.readouterr().err.startswith("Error:")
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "bogus"]) == 1
    assert "unknown variant" in capsys.readouterr().err


def test_cli_cuda_without_a_card_exits_1(tmp_path, scene_files, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pfile, ofile = scene_files
    out = tmp_path / "out"
    assert cli.main(["run", pfile, ofile, "--out-dir", str(out)]) == 1
    assert capsys.readouterr().err.strip() == "Error: no CUDA device"
    assert not out.exists()
    assert cli.main(["run", pfile, ofile, "--device", "cuda", "--out-dir", str(out)]) == 1
    assert not out.exists()
    with pytest.raises(ValueError, match="no CUDA device"):
        driver.run_simulation(_scene(16, 16), driver.RunConfig(variant="torch"))


def test_cli_bench_and_info(capsys):
    assert cli.main(["bench", "--grid", "16x16", "--steps", "5", "--repeats", "1",
                     "--device", "cpu"]) == 0
    import json

    report = json.loads(capsys.readouterr().out)
    assert report["unit"] == "MLUPS" and report["steps"] == 5 and report["device"] == "cpu"
    assert report["metric"] == "MLUPS 16x16 torch" and report["card"] is None
    assert cli.main(["info"]) == 0
    assert "torch" in capsys.readouterr().out
    scene = bench.make_scene("1024x1024")
    assert scene.params.max_iters == 20000 and scene.params.accel == 0.01


def test_port_imports_neither_jax_nor_lbm_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lbm_tpu_torch\n"
        "for m in pkgutil.walk_packages(lbm_tpu_torch.__path__, 'lbm_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import lbm_tpu_torch.cli, lbm_tpu_torch.models.driver\n"
        "import lbm_tpu_torch.ops.ensemble_cuda, lbm_tpu_torch.tools.ensemble\n"
        "import lbm_tpu_torch.tools.perfcheck\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lbm_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
