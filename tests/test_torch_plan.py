"""lbm_tpu_torch's ``run --plan`` (models/plan.py) against the driver and
against lbm_tpu's plan, on the CPU.

Modelled on tests/test_plan.py: the plan is built from the driver's own
selection functions, so over a matrix of variants, storages, observers and
step counts it says ``will FAIL`` exactly when ``run_simulation`` raises,
and otherwise its ``program`` line is the run's ``RunResult.variant``,
forcing variables included (on the CPU the cuda wrappers run their plain
versions through the same programs)."""

import warnings

import numpy as np
import pytest

from lbm_tpu.io.scene import Scene as JScene
from lbm_tpu.models import driver as jdriver
from lbm_tpu.models.plan import describe_plan as jdescribe_plan
from lbm_tpu.params import LBMParams as JParams
from lbm_tpu_torch import cli
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver
from lbm_tpu_torch.models.plan import describe_plan
from lbm_tpu_torch.models.variants import VARIANTS
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import scenegen


def _scene(ny=32, nx=64, steps=10):
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    r = np.random.default_rng(7)
    mask = r.random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return Scene(params, mask)


def _line(plan: str, key: str) -> str | None:
    """The first word after ``key: `` in the plan, or None."""
    for ln in plan.splitlines():
        if ln.startswith(key + ": "):
            return ln.split()[1]
    return None


def _held(scene, cfg):
    """Plan and run agree: ``will FAIL`` exactly when the run raises,
    otherwise the plan's program is the run's variant."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = describe_plan(scene, cfg)
        try:
            res = driver.run_simulation(scene, cfg)
        except ValueError as e:
            assert "will FAIL" in plan, f"the run raised {e!r}, the plan did not say so:\n{plan}"
            assert f"will FAIL: {e}" in plan
            return None
    assert "will FAIL" not in plan, f"the plan predicted a failure, the run passed:\n{plan}"
    assert _line(plan, "program") == res.variant, plan
    return res


@pytest.mark.parametrize("variant,staleness,devices", [
    ("torch", None, None), ("cuda", None, None), ("serial", None, None),
    ("sync", None, 4), ("async", 1, 4), ("chunked", 2, 4), ("ca", 4, 4), ("ca", None, 4),
])
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("obs", ["plain", "frames", "debug", "checkpoint"])
def test_plan_predicts_the_run(tmp_path, variant, staleness, devices, storage, obs):
    """10 steps take the remainder paths of chunked (k = 2) and ca (K = 4,
    8); frames every 3 steps are off chunked's chunk, and a checkpoint every
    4 steps off ca-8's sweep."""
    cfg = driver.RunConfig(
        variant=variant, device="cpu", host_devices=devices, staleness=staleness,
        storage=storage, num_steps=10,
        frame_interval=3 if obs == "frames" else None, debug=obs == "debug",
        checkpoint_every=4 if obs == "checkpoint" else None,
        checkpoint_dir=str(tmp_path / "ck"))
    res = _held(_scene(), cfg)
    if res is not None:
        assert res.av_vels.shape == (10,) and np.all(np.isfinite(res.av_vels))


@pytest.mark.parametrize("steps", [8, 13])
@pytest.mark.parametrize("variant", ["auto", "cuda"])
def test_plan_temporal_and_segments(variant, steps):
    """Forced int16 sweeps (K2 takes every small f32 grid) and segments: a
    segment is whole sweeps, the run's last with a K1 tail."""
    cfg = driver.RunConfig(variant=variant, device="cpu", num_steps=steps, temporal_k=4,
                           segment_steps=5, storage="i16")
    _held(_scene(), cfg)
    plan = describe_plan(_scene(), cfg)
    assert "kernel: K4-i16 " in plan and "sweep depth: K=4 (--temporal-k 4)" in plan
    assert f"segments: {-(-steps // 4)} (" in plan
    assert ("K1-i16 for the 1 step(s) outside whole sweeps" in plan) == bool(steps % 4)


@pytest.mark.parametrize("env,value,kw", [
    ("LBM_RESIDENT_KIND", "mono", {}),
    ("LBM_RESIDENT_KIND", "inplace", {}),
    ("LBM_RESIDENT_KIND", "blocked", {}),
    ("LBM_RESIDENT_KIND", "blocked", {"storage": "i16"}),
    ("LBM_RESIDENT_KIND", "mono", {"storage": "i16"}),
    ("LBM_RESIDENT_KIND", "bogus", {}),
    ("LBM_TEMPORAL_IMPL", "trapezoid", {"temporal_k": 2}),
    ("LBM_TEMPORAL_IMPL", "skew", {"temporal_k": 2}),
    ("LBM_TEMPORAL_IMPL", "skew", {"temporal_k": 4, "storage": "i16"}),
    ("LBM_TEMPORAL_IMPL", "hbm", {"temporal_k": 2}),
    ("LBM_TEMPORAL_IMPL", "hbm", {"temporal_k": 2, "storage": "i16"}),
    ("LBM_CA_ENGINE", "slab", {"variant": "ca", "host_devices": 4}),
    ("LBM_CA_ENGINE", "resident", {"variant": "ca", "host_devices": 4}),
    ("LBM_CA_ENGINE", "resident", {"variant": "ca", "host_devices": 4, "storage": "i16"}),
    ("LBM_CA_ENGINE", "inplace", {"variant": "ca", "host_devices": 4, "staleness": 8}),
    ("LBM_CA_ENGINE", "slab", {"variant": "auto", "host_devices": 4}),
    ("LBM_CA_PARTS", "2", {"variant": "ca", "host_devices": 2}),
    ("LBM_CA_PARTS", "7", {"variant": "ca", "host_devices": 2}),
])
def test_plan_under_forcing_variables(monkeypatch, env, value, kw):
    """``--variant cuda --device cpu`` (and ca) under each forcing variable:
    the plan reads it as the run does, so its program is RunResult.variant
    (or both refuse)."""
    monkeypatch.setenv(env, value)
    kw = {"variant": "cuda", **kw}
    _held(_scene(), driver.RunConfig(device="cpu", num_steps=9, **kw))


@pytest.mark.parametrize("variant", ["serial", "torch", "cuda", "sync", "overlap", "async",
                                     "async-k", "chunked", "ca"])
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_plan_lines_match_lbm_tpu(variant, storage):
    """The grid line equals lbm_tpu's; the variant line names lbm_tpu's
    variant (``torch`` is lbm_tpu's ``jnp``, ``cuda`` its ``pallas``)."""
    scene = _scene(32, 128)
    if storage == "i16" and variant in ("serial", "torch"):
        plan = describe_plan(scene, driver.RunConfig(variant=variant, device="cpu",
                                                      storage=storage))
        assert "will FAIL: storage 'i16'" in plan
        return
    sharded = VARIANTS[variant].sharded
    plan = describe_plan(scene, driver.RunConfig(
        variant=variant, device="cpu", storage=storage, host_devices=4 if sharded else None))
    analog = VARIANTS[variant].lbm_tpu_analog
    jscene = JScene(JParams(nx=128, ny=32, max_iters=10, reynolds_dim=10, density=0.1,
                            accel=0.005, omega=1.85), scene.obstacles)
    jplan = jdescribe_plan(jscene, jdriver.RunConfig(
        variant=analog, storage=storage, num_devices=4 if sharded else None))
    mine, theirs = plan.splitlines(), jplan.splitlines()
    assert mine[0] == theirs[0]
    assert (mine[2], theirs[1]) == (f"variant: {variant}", f"variant: {analog}")


def test_cli_plan_prints_and_runs_nothing(tmp_path, capsys):
    params = LBMParams(nx=64, ny=32, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    out = tmp_path / "out"
    rc = cli.main(["run", pfile, ofile, "--platform", "cpu", "--host-devices", "4",
                   "--variant", "chunked", "--steps", "11", "--plan", "--out-dir", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and not out.exists()
    assert "program: chunked-2+sync-tail1" in text and "shards: 4 x 8 rows" in text
    assert "(auto-selected)" not in text
    rc = cli.main(["run", pfile, ofile, "--platform", "cpu", "--plan", "--frame-interval", "0"])
    assert rc == 0 and "will FAIL: --frame-interval must be at least 1" in capsys.readouterr().out
