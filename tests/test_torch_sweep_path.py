"""The port's temporal sweep path (K5, and K9 where forced) on the CPU, as
the policy takes it for a grid beyond the L2 budgets, here by setting
those budgets and the sweeps' minimum sizes to 0.

- Against the benchmark's plain reference (``portbench/reference/lbm.py``,
  the upstream's serial solver in plain PyTorch): ``run_simulation`` with
  ``variant="cuda"``, whose wrappers run their plain sweeps on the CPU, in
  several segments and a K1 tail, judged by the benchmark's own numbers
  (``portbench/jobs.gaps``); the reference with its state rounded to
  bfloat16 after every step fails the same limits.
- The ranges: while a profiler records, each runner call marks its whole
  sweeps ``lbm.sweeps.k<K>`` and its remainder ``lbm.tail``, inside
  ``lbm.compute``; with none recording no range is opened.
- The counters ``RunResult.sweep_k``, ``sweeps`` and ``tail_steps``, on
  the sweep path and off it, and ``run``'s line of them on stderr (on the
  sweep path only).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lbm_tpu_torch import cli
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import hbm_cuda, inplace_cuda, resident_cuda, temporal_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import scenegen
from lbm_tpu_torch.utils import timing

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import jobs  # noqa: E402
from portbench.reference import lbm as reference  # noqa: E402

torch.set_num_threads(1)

DENSITY, ACCEL = 0.1, 0.005
# 30 steps in segments of 8: three segments of two sweeps, then one of a
# sweep and a K1 tail of 2 steps (30 = 7 x 4 + 2).
STEPS, SEGMENT, K = 30, 8, 4

# Limits on the benchmark's numbers (jobs.gaps).  Both sides are float32
# implementations of one scheme that order their arithmetic differently
# (the port's paired equilibria and moment-reused |u| against the C
# source's form), so after 30 steps they differ by float32 rounding alone:
# at most 9.2e-7 (f_gap) and 9.5e-9 (av_gap) over the 8 seeds of both
# grids tried.  The limits leave 20x and 10x room above that; the
# reference with a bfloat16 state (2^-9 relative a rounding, every step)
# read at least 3.7e-3 and 6.2e-5 on the same cases, 190x and 600x above
# them.
LIMITS = {"f_gap": 2e-5, "av_gap": 1e-7}
GRIDS = [(48, 40), (64, 64)]


@pytest.fixture
def sweep_policy(monkeypatch):
    """The policy as it stands beyond the L2 budgets: no resident kernel
    maps, and the sweeps' size thresholds are met by any grid."""
    for var in ("LBM_TEMPORAL_K", "LBM_TEMPORAL_IMPL", "LBM_RESIDENT_KIND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 0)
    monkeypatch.setattr(temporal_cuda, "SWEEP_MIN_CELLS", 0)
    monkeypatch.setattr(program, "SKEW_MIN_CELLS", 0)
    return monkeypatch


def _scene(ny, nx, seed, steps=STEPS):
    """A closed box with random walls inside (about 1 cell in 10) and an
    omega from 1.3-1.9, both drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    omega = float(np.float32(rng.uniform(1.3, 1.9)))
    mask = rng.random((ny, nx)) < 0.1
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=omega)
    return Scene(params=params, obstacles=mask)


def _run(scene, **kw):
    cfg = dict(variant="cuda", device="cpu", segment_steps=SEGMENT)
    return driver.run_simulation(scene, driver.RunConfig(**{**cfg, **kw}))


def _reference(scene, store=None):
    f, av = reference.run(torch.from_numpy(scene.obstacles), [scene.params.omega], [ACCEL],
                          DENSITY, scene.params.max_iters, torch.float32, store)
    return f.float().numpy(), av.numpy()


def _gaps(res, ref_f, ref_av):
    return jobs.gaps(jobs.JobOut(res.f[None], res.av_vels[:, None], None, res.variant),
                     ref_f, ref_av)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("ny,nx", GRIDS)
def test_policy_sweep_matches_the_plain_reference(sweep_policy, ny, nx, seed):
    scene = _scene(ny, nx, seed)
    res = _run(scene)
    assert res.variant == "cuda-skew" and (res.sweep_k, res.sweeps, res.tail_steps) == (K, 7, 2)
    assert driver._segment_lengths(STEPS, driver.RunConfig(segment_steps=SEGMENT), K) == [
        8, 8, 8, 6]
    got = _gaps(res, *_reference(scene))
    assert all(got[k] <= LIMITS[k] for k in jobs.CHECKS), got


@pytest.mark.parametrize("ny,nx", GRIDS)
def test_a_bfloat16_state_fails_the_limits(ny, nx):
    """The control: the reference with its state rounded to bfloat16 after
    every step, held to the float32 reference, exceeds both limits, so the
    limits tell a sound float32 run from one of lower precision."""
    scene = _scene(ny, nx, 11)
    ref_f, ref_av = _reference(scene)
    f, av = _reference(scene, torch.bfloat16)
    got = jobs.gaps(jobs.JobOut(f, av.astype(np.float32), None, "bf16"), ref_f, ref_av)
    assert all(got[k] > LIMITS[k] for k in jobs.CHECKS), got


def _trace(call, path):
    """(call's result, the trace's ``lbm.*`` host ranges as (name, start, end), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                        and e["name"].startswith(timing.SPAN_PREFIX)), key=lambda s: s[1])


@pytest.mark.parametrize("impl", ["auto", "hbm"])
def test_sweep_and_tail_ranges_nest_in_compute(sweep_policy, impl, tmp_path):
    """One ``lbm.sweeps.k4`` a segment and one ``lbm.tail``, inside
    ``lbm.compute`` and in step order, on K5's runner (the policy's) and on
    K9's (forced); the ranges change no output."""
    if impl == "hbm":
        sweep_policy.setenv("LBM_TEMPORAL_IMPL", "hbm")
        sweep_policy.setattr(hbm_cuda, "L2_SLOTS_BUDGET", 2**20)
    scene = _scene(48, 40, 13)
    plain = _run(scene)
    res, ranges = _trace(lambda: _run(scene), tmp_path / "trace.json")
    assert res.variant == {"auto": "cuda-skew", "hbm": "cuda-hbm"}[impl]
    np.testing.assert_array_equal(res.f, plain.f)
    np.testing.assert_array_equal(res.av_vels, plain.av_vels)
    (compute,) = [r for r in ranges if r[0] == "lbm.compute"]
    inner = [r for r in ranges if r[0] in ("lbm.sweeps.k4", "lbm.tail")]
    assert [r[0] for r in inner] == ["lbm.sweeps.k4"] * 4 + ["lbm.tail"]
    assert all(compute[1] <= a and b <= compute[2] for _, a, b in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_no_sweep_range_without_a_profiler(sweep_policy):
    opened = []

    class Counted(timing.record_function):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    sweep_policy.setattr(timing, "record_function", Counted)
    scene = _scene(48, 40, 14)
    _run(scene)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _run(scene)
    assert opened.count("lbm.sweeps.k4") == 4 and opened.count("lbm.tail") == 1


@pytest.mark.parametrize("steps,segment,want", [
    (30, 8, (4, 7, 2)),  # segments 8, 8, 8, 6
    (32, 0, (4, 8, 0)),  # one call, whole sweeps
    (3, None, (4, 0, 3)),  # fewer steps than a sweep: the tail alone
    (30, 6, (4, 7, 2)),  # 6 rounds down to one sweep a segment
])
def test_counters_on_the_sweep_path(sweep_policy, steps, segment, want):
    """sweep_k, sweeps and tail_steps are K, steps // K and steps mod K,
    however the run is cut into segments (each segment is whole sweeps but
    the last)."""
    res = _run(_scene(48, 40, 15, steps), segment_steps=segment)
    assert res.variant == "cuda-skew"
    assert (res.sweep_k, res.sweeps, res.tail_steps) == want == (K, steps // K, steps % K)


@pytest.mark.parametrize("kind,variant", [("inplace", "cuda-inplace"), ("torch", "torch")])
def test_counters_off_the_sweep_path(monkeypatch, kind, variant):
    """Off the sweeps (K3's path, and the plain torch step): 1, 0, 0."""
    monkeypatch.delenv("LBM_TEMPORAL_K", raising=False)
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    res = _run(_scene(48, 40, 16), variant="cuda" if kind == "inplace" else "torch")
    assert res.variant == variant
    assert (res.sweep_k, res.sweeps, res.tail_steps) == (1, 0, 0)


def test_cli_run_prints_the_counters(sweep_policy, tmp_path, capsys):
    params = LBMParams(nx=48, ny=32, max_iters=30, reynolds_dim=10, density=DENSITY,
                       accel=ACCEL, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                     "--no-output"]) == 0
    out, err = capsys.readouterr()
    assert "Variant:\t\t\tcuda-skew" in out
    assert "Sweeps: K=4, 7 sweeps, 2 tail steps" in err
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                     "--temporal-k", "1", "--no-output"]) == 0
    assert "Sweeps:" not in capsys.readouterr().err  # off the sweep path: no line
