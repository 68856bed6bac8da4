"""Frames, debug and checkpoint/resume of lbm_tpu_torch's driver and CLI.

Against ``lbm_tpu``'s ``run_simulation`` on its jnp variant (XLA's FMA
contraction on the CPU, ROADMAP queue C): frames within atol 2e-7, frame
steps equal, per-step densities within rtol 1e-6 of the conserved mass and
1e-5 of lbm_tpu's (XLA's float32 sum strays more), fields atol 2e-7 and av
rtol 1e-4.  Inside the port the relations are bitwise: plain, frames and
debug runs have equal fields and av_vels at step counts that are and are
not multiples of the interval, chunk or K (ca: fields; its |u| is summed per
sweep level where sync sums per step, av within rtol 1e-6), and a resumed
run equals the unbroken one.  ``lbm_tpu`` is imported inside the tests
that compare against it.
"""

import dataclasses
import filecmp
import re

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import resident_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import animation, scenegen

torch.set_num_threads(1)


def _scene(ny=32, nx=64, seed=4):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.06
    mask[0, :] = mask[-1, :] = True
    return Scene(params, mask)


def _jscene(scene):
    from lbm_tpu.io.scene import Scene as JScene
    from lbm_tpu.params import LBMParams as JParams

    return JScene(JParams(**dataclasses.asdict(scene.params)), scene.obstacles)


def _run(scene, **kw):
    return driver.run_simulation(scene, driver.RunConfig(device="cpu", **kw))


def _densities(text):
    return np.array([float(v) for v in re.findall(r"tot density: (\S+)", text)])


# (variant, RunConfig fields, environment): the port's variants with a
# per-step decomposition, on the CPU (the cuda backend's plain versions).
_VARIANTS = {
    "torch": ({"variant": "torch"}, {}),
    "cuda-resident": ({"variant": "cuda"}, {}),
    "cuda-blocked": ({"variant": "cuda"}, {"LBM_RESIDENT_KIND": "blocked"}),
    "cuda-trapezoid": ({"variant": "cuda", "temporal_k": 2}, {}),
    "sync": ({"variant": "sync", "host_devices": 4}, {}),
    "overlap": ({"variant": "overlap", "host_devices": 4}, {}),
    "chunked-2": ({"variant": "chunked", "host_devices": 4}, {}),
    "ca-8": ({"variant": "ca", "host_devices": 4}, {}),
}


@pytest.mark.parametrize("steps", [20, 23], ids=lambda s: f"{s} steps")
@pytest.mark.parametrize("name", list(_VARIANTS))
def test_plain_frames_and_debug_runs_are_equal(monkeypatch, capsys, name, steps):
    kw, env = _VARIANTS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if name == "cuda-trapezoid":  # K4 at K = 2 on a grid K2 would otherwise take
        monkeypatch.setattr(resident_cuda, "fits_l2", lambda ny, nx: False)
    scene = _scene()
    plain = _run(scene, num_steps=steps, **kw)
    frames = _run(scene, num_steps=steps, frame_interval=10, **kw)
    debug = _run(scene, num_steps=steps, debug=True, **kw)
    assert plain.variant.split("+")[0] == name and frames.variant == name
    assert debug.variant == (f"{name}+debug-as-sync" if name.startswith("ca") else name)
    assert len(_densities(capsys.readouterr().out)) == steps
    for res in (frames, debug):
        np.testing.assert_array_equal(res.f, plain.f)
        if name.startswith("ca"):
            np.testing.assert_allclose(res.av_vels, plain.av_vels, rtol=1e-6)
        else:
            np.testing.assert_array_equal(res.av_vels, plain.av_vels)
        assert res.steps_computed == steps
    n_frames = -(-steps // 10)
    assert frames.frames.shape == (n_frames, 32, 64)
    np.testing.assert_array_equal(frames.frame_steps, np.arange(n_frames) * 10)
    one = _run(scene, num_steps=1, **kw)
    u = program.u_mag_fn(torch.from_numpy(scene.obstacles))(torch.from_numpy(one.f))
    np.testing.assert_array_equal(frames.frames[0], u.numpy())
    if name != "chunked-2":  # per-step programs take frames and debug together
        both = _run(scene, num_steps=steps, frame_interval=10, debug=True, **kw)
        capsys.readouterr()
        np.testing.assert_array_equal(both.frames, frames.frames)
        np.testing.assert_array_equal(both.f, plain.f)


def test_frames_and_debug_match_lbm_tpu(capsys):
    """64x64 on the jnp variant against the torch one: frames, their steps,
    per-step densities, fields and av.  8 steps: the fields' FMA difference
    grows by ~5e-8 per 5 steps here and |u| divides it by rho ~ 0.1, so the
    frames leave atol 2e-7 from about step 10 on.  Densities: XLA's float32
    sum of the 36864 values on the CPU strays 7.6e-6 relative from the mass
    (0.1 per cell: 409.6, conserved by the step); torch's stays within 1e-6
    of it, so the two are held to each other at rtol 1e-5."""
    from lbm_tpu.models import driver as jdriver

    scene = _scene(64, 64)
    res = _run(scene, variant="torch", num_steps=8, frame_interval=3, debug=True)
    out = capsys.readouterr().out
    ref = jdriver.run_simulation(_jscene(scene), jdriver.RunConfig(
        variant="jnp", num_steps=8, frame_interval=3, debug=True))
    ref_out = capsys.readouterr().out
    assert res.frames.shape == ref.frames.shape == (3, 64, 64)
    np.testing.assert_allclose(res.frames, ref.frames, atol=2e-7)
    np.testing.assert_array_equal(res.frame_steps, ref.frame_steps)
    np.testing.assert_allclose(_densities(out), 0.1 * 64 * 64, rtol=1e-6)
    np.testing.assert_allclose(_densities(out), _densities(ref_out), rtol=1e-5)
    assert len(_densities(out)) == 8
    np.testing.assert_allclose(res.f, ref.f, atol=2e-7)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)
    lines = [ln for ln in out.splitlines() if ln.startswith(("==timestep", "av velocity"))]
    ref_lines = [ln for ln in ref_out.splitlines()
                 if ln.startswith(("==timestep", "av velocity"))]
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in ref_lines]


def test_frame_files_are_lbm_tpu_s_bytes(tmp_path):
    from lbm_tpu.params import LBMParams as JParams
    from lbm_tpu.tools import animation as janimation

    p = _scene(12, 20).params
    frames = np.random.default_rng(1).random((3, 12, 20)).astype(np.float32)
    steps = np.array([0, 7, 14])
    ours = animation.write_frame_files(str(tmp_path / "t"), frames, steps, p)
    theirs = janimation.write_frame_files(str(tmp_path / "j"), frames, steps,
                                          JParams(**dataclasses.asdict(p)))
    assert [pathlib_name(a) for a in ours] == [pathlib_name(b) for b in theirs]
    for a, b in zip(ours, theirs):
        assert filecmp.cmp(a, b, shallow=False)
    vals, meta = animation.read_frame_file(ours[1])
    assert meta == {"nx": 20, "ny": 12, "timestep": 7} and vals.shape == (12, 20)
    np.testing.assert_allclose(vals, frames[1], rtol=1e-6)


def pathlib_name(path):
    return path.rsplit("/", 1)[-1]


@pytest.mark.parametrize("name", ["torch", "cuda-blocked", "sync", "chunked-2", "ca-8"])
def test_resumed_run_equals_the_unbroken_one(tmp_path, monkeypatch, name):
    kw, env = _VARIANTS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    scene = _scene()
    whole = _run(scene, num_steps=24, **kw)
    ck = _run(scene, num_steps=24, checkpoint_every=8, checkpoint_dir=str(tmp_path), **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000008.npz", "ckpt_00000016.npz", "ckpt_00000024.npz"]
    with np.load(tmp_path / "ckpt_00000016.npz") as z:
        assert int(z["step"]) == 16 and z["av_vels"].shape == (16,)
        assert z["f"].dtype == np.float32 and z["f"].shape == (9, 32, 64)
    res = _run(scene, num_steps=24, resume_from=str(tmp_path / "ckpt_00000008.npz"), **kw)
    for r in (ck, res):
        np.testing.assert_array_equal(r.f, whole.f)
        np.testing.assert_array_equal(r.av_vels, whole.av_vels)
    assert res.steps_computed == 16 and len(res.av_vels) == 24


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port checkpoint resumes in lbm_tpu, and lbm_tpu's in the port."""
    from lbm_tpu.models import driver as jdriver

    scene = _scene()
    js = _jscene(scene)
    ref = jdriver.run_simulation(js, jdriver.RunConfig(variant="jnp", num_steps=20))
    _run(scene, variant="torch", num_steps=12, checkpoint_every=12,
         checkpoint_dir=str(tmp_path / "t"))
    jdriver.run_simulation(js, jdriver.RunConfig(
        variant="jnp", num_steps=12, checkpoint_every=12, checkpoint_dir=str(tmp_path / "j")))
    in_j = jdriver.run_simulation(js, jdriver.RunConfig(
        variant="jnp", num_steps=20, resume_from=str(tmp_path / "t" / "ckpt_00000012.npz")))
    in_t = _run(scene, variant="cuda", num_steps=20,
                resume_from=str(tmp_path / "j" / "ckpt_00000012.npz"))
    for res in (in_j, in_t):
        np.testing.assert_allclose(res.f, ref.f, atol=2e-7)
        np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)
        assert len(res.av_vels) == 20


@pytest.mark.parametrize("engine,allowed", [(None, True), ("slab", False)],
                         ids=["K8-i16", "K4-slab-i16"])
def test_int16_ca_observed_only_on_k8(monkeypatch, capsys, engine, allowed):
    """int16 ca quantizes every step on K8-i16, as sync-i16 does, so it may
    be observed per step; K4-slab-i16 quantizes once per sweep and refuses,
    with lbm_tpu's words.  auto on 4 shards takes the same rule (C2)."""
    if engine:
        monkeypatch.setenv("LBM_CA_ENGINE", engine)
    scene = _scene()
    kw = dict(host_devices=4, storage="i16", num_steps=19)
    auto = driver.choose_variant(scene, driver.RunConfig(device="cpu", debug=True, **kw),
                                 torch.device("cpu"))
    assert driver.choose_variant(scene, driver.RunConfig(device="cpu", **kw),
                                 torch.device("cpu")) == "ca"
    assert auto == ("ca" if allowed else "overlap")
    if not allowed:
        with pytest.raises(ValueError, match="debug tracing is not supported with ca-4-i16"):
            _run(scene, variant="ca", debug=True, **kw)
        with pytest.raises(ValueError, match="--frame-interval with i16 ca is not supported"):
            _run(scene, variant="ca", frame_interval=5, **kw)
        return
    plain = _run(scene, variant="ca", **kw)
    debug = _run(scene, variant="auto", debug=True, **kw)
    frames = _run(scene, variant="ca", frame_interval=5, **kw)
    sync = _run(scene, variant="sync", **kw)
    capsys.readouterr()
    assert debug.variant == "ca-8-i16+debug-as-sync" and frames.variant == "ca-8-i16"
    for res in (debug, frames, sync):
        np.testing.assert_array_equal(res.f, plain.f)


def test_observed_run_refusals(tmp_path):
    scene = _scene()
    with pytest.raises(ValueError, match="frames and --debug cannot be combined"):
        _run(scene, variant="chunked", host_devices=4, frame_interval=4, debug=True)
    with pytest.raises(ValueError, match="multiple of the 2-step chunk"):
        _run(scene, variant="chunked", host_devices=4, frame_interval=5)
    with pytest.raises(ValueError, match="frames/debug are not supported with checkpointing"):
        _run(scene, variant="torch", frame_interval=5, checkpoint_every=5)
    with pytest.raises(ValueError, match="checkpoint_every must be a multiple of the chunk"):
        _run(scene, variant="chunked", host_devices=4, checkpoint_every=5)
    with pytest.raises(ValueError, match="multiple of the 2-step chunk"):
        _run(scene, variant="chunked", host_devices=4, num_steps=21, checkpoint_every=4)
    with pytest.raises(ValueError, match="serial oracle"):
        _run(scene, variant="serial", checkpoint_every=5)
    with pytest.raises(ValueError, match="serial oracle"):
        _run(scene, variant="serial", debug=True)
    with pytest.raises(ValueError, match="--frame-interval must be at least 1"):
        _run(scene, variant="torch", frame_interval=0)
    _run(scene, variant="torch", num_steps=10, checkpoint_every=10,
         checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="beyond num_steps"):
        _run(scene, variant="torch", num_steps=10, resume_from=str(tmp_path / "ckpt_00000010.npz"))
    small = _scene(16, 16)
    with pytest.raises(ValueError, match="does not match scene"):
        _run(small, variant="torch", resume_from=str(tmp_path / "ckpt_00000010.npz"))


def test_segments_of_each_kind_of_run():
    """One loop serves every run: plain runs in whole chunks then the tail,
    frames after 1, 1 + k * interval steps, debug per step, checkpoints
    every N steps; a chunked segment takes whole chunks through the
    program's runner and the rest through its primitives."""
    scene = _scene()
    cfg = driver.RunConfig(device="cpu", variant="chunked", host_devices=4, staleness=4)
    prog = driver.build_program(scene, cfg, torch.device("cpu"))
    plan = driver._segments
    assert plan(dataclasses.replace(cfg, segment_steps=8), prog, 27) == [
        (0, 8), (8, 8), (16, 8), (24, 3)]
    assert plan(cfg, prog, 27) == [(0, 24), (24, 3)]
    assert plan(dataclasses.replace(cfg, frame_interval=8), prog, 27) == [
        (0, 1), (1, 8), (9, 8), (17, 8), (25, 2)]
    assert plan(dataclasses.replace(cfg, debug=True), prog, 3) == [(0, 1), (1, 1), (2, 1)]
    assert plan(dataclasses.replace(cfg, checkpoint_every=8), prog, 20) == [
        (0, 8), (8, 8), (16, 4)]
    assert plan(cfg, prog, 0) == []
    advance = driver._Advance(scene, cfg, torch.device("cpu"), prog, 27)
    calls = []
    prog_runner = prog.make_run_all
    prog.make_run_all = lambda n: calls.append(n) or prog_runner(n)
    advance(1, 8)  # steps 1-3 and 8 through the primitives, 4-7 one chunk
    advance(17, 8)  # 17-19 primitives, 20-23 a chunk, 24 the sync tail
    assert calls == [4] and advance.primitives


def test_chunked_frames_at_mid_chunk_phases():
    """chunked-4: frames every 8 steps land at in-chunk phase 1 and the run
    ends in the sync tail; every frame equals u_mag of the plain run
    stopped at its step."""
    scene = _scene()
    kw = dict(variant="chunked", host_devices=4, staleness=4)
    res = _run(scene, num_steps=27, frame_interval=8, **kw)
    mag = program.u_mag_fn(torch.from_numpy(scene.obstacles))
    for k, tt in enumerate(res.frame_steps):
        stop = _run(scene, num_steps=int(tt) + 1, **kw)
        np.testing.assert_array_equal(res.frames[k], mag(torch.from_numpy(stop.f)).numpy())
    np.testing.assert_array_equal(res.f, _run(scene, num_steps=27, **kw).f)


def test_cli_frames_debug_checkpoint_resume(tmp_path, capsys):
    """``run`` writes animation_data/ in lbm_tpu's format and debug lines in
    its format; --checkpoint-every then --resume write the unbroken run's
    files byte for byte."""
    params = LBMParams(nx=40, ny=24, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    base = ["run", pfile, ofile, "--device", "cpu"]
    assert cli.main(base + ["--out-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(base + ["--frame-interval", "10", "--out-dir", str(tmp_path / "fr")]) == 0
    assert cli.main(base + ["--debug", "--out-dir", str(tmp_path / "dbg")]) == 0
    out = capsys.readouterr().out
    assert re.search(r"==timestep: 29==\nav velocity: \d\.\d{12}E[-+]\d\d\n"
                     r"tot density: \d\.\d{12}E[-+]\d\d\n==done==", out)
    names = sorted(p.name for p in (tmp_path / "fr" / "animation_data").iterdir())
    assert names == [f"velocity_magnitude_{t:06d}.dat" for t in (0, 10, 20)]
    ck = ["--checkpoint-every", "10", "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli.main(base + ck + ["--out-dir", str(tmp_path / "ckpt")]) == 0
    assert cli.main(base + ["--resume", str(tmp_path / "ck" / "ckpt_00000020.npz"),
                            "--out-dir", str(tmp_path / "res")]) == 0
    for d in ("fr", "dbg", "ckpt", "res"):
        for f in ("final_state.dat", "av_vels.dat"):
            assert filecmp.cmp(tmp_path / d / f, tmp_path / "plain" / f, shallow=False), (d, f)
    assert cli.main(base + ["--resume", str(tmp_path / "missing.npz")]) == 1
    assert capsys.readouterr().err.startswith("Error:")
