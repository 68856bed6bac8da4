"""The port's speed gate (tools/perfcheck.py) on the CPU: its table of
rows and floors, and its exit codes with the measurement stubbed.  The
rates themselves are the card's (chip_smoke.py runs the gate on the
H100)."""

import pytest
import torch

from lbm_tpu_torch.models import program
from lbm_tpu_torch.models.driver import RunConfig
from lbm_tpu_torch.models.plan import describe_plan
from lbm_tpu_torch.ops import ensemble_cuda
from lbm_tpu_torch.tools import perfcheck
from lbm_tpu_torch.tools.bench import make_scene
from test_torch_cluster import h100_clusters  # the H100's answers to K11's query

# What the default policy launches: the single-device programs of
# program.cuda_choice, the sharded ones of lbm_tpu's rule on 4 shards
# (ca where it maps), and the ensemble's three kernels.
DEFAULT_PROGRAMS = {"cuda-resident", "cuda-inplace", "cuda-skew", "cuda-inplace-i16",
                    "cuda-step-i16", "ca-8", "ca-8-i16", "ca-4", "K1-batch", "K2-batch", "K11"}


def _plan_program(check):
    opts = dict(check.options)
    sharded = "host_devices" in opts
    config = RunConfig(variant=opts.get("variant", "auto" if sharded else "cuda"),
                       device="cpu", num_steps=check.steps, storage=check.storage,
                       host_devices=opts.get("host_devices"), backend="cuda" if sharded else None)
    lines = describe_plan(make_scene(check.grid), config).splitlines()
    return next(ln.split(": ", 1)[1] for ln in lines if ln.startswith("program: "))


@pytest.mark.parametrize("check", perfcheck.CHECKS, ids=lambda c: f"{c.grid}-{c.program}")
def test_each_row_is_half_its_cited_rate_and_names_its_program(check):
    assert check.rate > 0 and check.floor == check.rate / 2
    if check.instances is None:
        assert _plan_program(check) == check.program
    else:
        n = int(check.grid.split("x")[0])
        assert ensemble_cuda.kernel_choice(n, n, check.instances, 528,  # H100
                                           h100_clusters) == check.program


def test_every_default_path_has_a_row():
    programs = [c.program for c in perfcheck.CHECKS]
    assert DEFAULT_PROGRAMS <= set(programs)
    for n in (128, 256, 512, 768, 1024, 1536, 2048, 4096):
        for storage in ("f32", "i16"):
            assert program.cuda_choice(make_scene(f"{n}x{n}").params, storage)[0] in programs


def _stub(monkeypatch, scale=1.0, wrong=None):
    def measure(check, repeats=2):
        assert repeats == 2
        return check.rate * scale, (wrong if check is perfcheck.CHECKS[3] and wrong
                                    else check.program)

    monkeypatch.setattr(perfcheck, "measure", measure)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_main_passes_above_every_floor(monkeypatch, capsys):
    _stub(monkeypatch, 0.6)
    assert perfcheck.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln[:4] for ln in out[:-1]] == ["OK  "] * len(perfcheck.CHECKS)
    assert out[-1] == "all kernel paths at speed"


def test_main_fails_below_a_floor(monkeypatch, capsys):
    _stub(monkeypatch, 0.4)
    assert perfcheck.main() == 1
    captured = capsys.readouterr()
    assert captured.out.count("FAIL") == len(perfcheck.CHECKS)
    assert "below their regression floor" in captured.err


def test_main_fails_on_the_wrong_program(monkeypatch, capsys):
    _stub(monkeypatch, 1.0, wrong="cuda-trapezoid")
    assert perfcheck.main() == 1
    fails = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("FAIL")]
    assert len(fails) == 1 and "cuda-trapezoid" in fails[0]


def test_main_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert perfcheck.main() == 1
    assert capsys.readouterr().err.startswith("Error:")
