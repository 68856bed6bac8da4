"""lbm_tpu_torch's phase spans (utils/timing.py) on the CPU.

While a torch profiler records, ``run_simulation`` and ``run_ensemble``
each leave one ``lbm.run_simulation`` / ``lbm.run_ensemble`` range in its
Chrome trace, and inside it one ``lbm.init``, ``lbm.compute`` and
``lbm.collate``, in that order, each as long as the timer's phase.  With
none recording, no range is opened and the timer reads as before; the
profiler changes no output.  On a card (``cuda``) the outputs' host copies
add ``lbm.host_prepare`` inside ``lbm.compute`` and ``lbm.fetch`` inside
``lbm.collate`` (utils/hostcopy.py); on the CPU they open none."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import ensemble
from lbm_tpu_torch.utils import timing

torch.set_num_threads(1)

PHASES = ("init", "compute", "collate")


def _params(steps=20):
    return LBMParams(nx=16, ny=16, max_iters=steps, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85)


def _mask():
    mask = np.zeros((16, 16), dtype=bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    mask[5:7, 8:10] = True
    return mask


def _simulate():
    res = driver.run_simulation(Scene(_params(), _mask()),
                                driver.RunConfig(variant="torch", device="cpu"))
    return res, res.f, res.av_vels


def _ensemble():
    res = ensemble.run_ensemble(_params(), _mask(), np.asarray([1.3, 1.6, 1.9], np.float32),
                                device="cpu")
    return res, res.f, res.av_vels


ENTRIES = {"run_simulation": _simulate, "run_ensemble": _ensemble}


def _traced(call, path):
    """(call's result, the trace's ``lbm.*`` host ranges in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(timing.SPAN_PREFIX)), key=lambda e: e["ts"])
    return out, spans


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_phases_nest_in_the_entry_points_span(entry, tmp_path):
    (res, _, _), spans = _traced(ENTRIES[entry], tmp_path / "trace.json")
    assert [s["name"] for s in spans] == [f"lbm.{entry}"] + [f"lbm.{p}" for p in PHASES]
    outer, phases = spans[0], spans[1:]
    for s in phases:
        assert outer["ts"] <= s["ts"] and s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for p, s in zip(PHASES, phases):
        got, want = s["dur"] * 1e-6, res.timer.elapsed[p]
        assert abs(got - want) <= max(1e-3, 0.1 * want), (p, got, want)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_range_without_a_profiler(entry, monkeypatch):
    """Without a profiler no range is opened (the fake counts every one);
    under one, one a phase and one for the call."""
    opened = []

    class Counted(timing.record_function):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(timing, "record_function", Counted)
    res, _, _ = ENTRIES[entry]()
    assert opened == []
    assert all(res.timer.elapsed[p] > 0 for p in PHASES) and res.timer.total > 0
    with profile(activities=[ProfilerActivity.CPU]):
        ENTRIES[entry]()
    assert opened == [f"lbm.{entry}"] + [f"lbm.{p}" for p in PHASES]


def test_ensemble_timer_and_outputs_under_the_profiler(tmp_path):
    res, f, av = _ensemble()
    assert set(res.timer.elapsed) == set(PHASES)
    assert all(res.timer.elapsed[p] > 0 for p in PHASES)
    (traced, f_t, av_t), _ = _traced(_ensemble, tmp_path / "trace.json")
    assert np.array_equal(f, f_t) and np.array_equal(av, av_t)
    assert np.array_equal(res.reynolds, traced.reynolds)


def test_a_range_outlives_the_profiler_that_opened_it(tmp_path):
    """A phase started under a profiler and stopped after it closes its
    range; one started before a profiler opens none."""
    timer = timing.PhaseTimer()
    timer.start("init")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timer.stop("init")
        timer.start("compute")
        assert list(timer._ranges) == ["compute"]
    timer.stop("compute")
    assert timer._ranges == {}
    assert timer.elapsed["init"] > 0 and timer.elapsed["compute"] > 0
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = [e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert "lbm.init" not in names


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_simulate():
    res = driver.run_simulation(Scene(_params(300).replace(nx=256, ny=256), _box(256)),
                                driver.RunConfig(device="cuda", num_devices=1))
    return res, res.f, res.av_vels


def _card_ensemble():
    res = ensemble.run_ensemble(_params(300).replace(nx=128, ny=128), _box(128),
                                np.linspace(1.3, 1.9, 16, dtype=np.float32), device="cuda")
    return res, res.f, res.av_vels


def _box(n):
    mask = np.zeros((n, n), dtype=bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    return mask


CARD_ENTRIES = {"run_simulation": _card_simulate, "run_ensemble": _card_ensemble}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(CARD_ENTRIES))
def test_host_copy_ranges_nest_in_their_phases_on_card(entry, cuda_device, tmp_path):
    """On a card the outputs' host arrays are prepared inside ``lbm.compute``
    (``lbm.host_prepare``, one an output) and copied inside ``lbm.collate``
    (``lbm.fetch``, one an output): utils/hostcopy.py."""
    _, spans = _traced(CARD_ENTRIES[entry], tmp_path / "trace.json")
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append((s["ts"], s["ts"] + s["dur"]))
    for inner, outer in (("lbm.host_prepare", "lbm.compute"), ("lbm.fetch", "lbm.collate")):
        assert len(by_name[inner]) == 2 and len(by_name[outer]) == 1
        (lo, hi), = by_name[outer]
        assert all(lo <= a and b <= hi for a, b in by_name[inner]), inner
