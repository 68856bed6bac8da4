"""A run whose timed path is broken underneath comes out not correct.

The chip's look is skipped and the rest of a run is driven on the CPU, at a
small size, with the program's own plain step (the path its CPU runs take)
broken in each way a cell can be: a step that returns its state unchanged,
half of an ensemble left out (its instances given the other half's
results), and an answer altered where it is produced.  A cell on one chip
has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench.tests.helpers import SMALL_SCENE, SMALL_SWEEP, run_small, small_cell


def unchanged_step(monkeypatch):
    from lbm_tpu_torch.ops import fused_torch

    step = fused_torch.fused_step_single
    monkeypatch.setattr(fused_torch, "fused_step_single",
                        lambda f, o, p: fused_torch.StepOutput(f, step(f, o, p).tot_u))
    batch = fused_torch.ensemble_step
    monkeypatch.setattr(fused_torch, "ensemble_step",
                        lambda f_b, *a: (f_b.clone(), batch(f_b, *a)[1]))


def half_batch_left_out(monkeypatch):
    from lbm_tpu_torch.ops import fused_torch

    batch = fused_torch.ensemble_step

    def step(f_b, obstacles, omegas, w1s, w2s, row):
        h = f_b.shape[0] // 2
        f, tot = batch(f_b[:h], obstacles, omegas[:h], w1s[:h], w2s[:h], row)
        return torch.cat([f, f]), torch.cat([tot, tot])

    monkeypatch.setattr(fused_torch, "ensemble_step", step)


def answer_altered(monkeypatch):
    from lbm_tpu_torch.ops import fused_torch

    run, batch = fused_torch.run_steps, fused_torch.run_ensemble_plain

    def run_steps(*a, **k):
        f, tots = run(*a, **k)
        f = f.clone()
        f[1, 5, 7] *= 1.1
        return f, tots

    def run_batch(*a, **k):
        f, tot = batch(*a, **k)
        tot = tot.clone()
        tot[-1, 0] *= 1.1
        return f, tot

    monkeypatch.setattr(fused_torch, "run_steps", run_steps)
    monkeypatch.setattr(fused_torch, "run_ensemble_plain", run_batch)


CASES = [("refbox.1024", SMALL_SCENE, unchanged_step), ("sweep128.omega64", SMALL_SWEEP,
                                                        unchanged_step),
         ("sweep128.omega64", SMALL_SWEEP, half_batch_left_out),
         ("refbox.1024", SMALL_SCENE, answer_altered),
         ("sweep128.omega64", SMALL_SWEEP, answer_altered)]


@pytest.mark.parametrize("base,traffic,fault", CASES,
                         ids=[f"{b}-{f.__name__}" for b, _, f in CASES])
def test_fault_is_not_correct(tmp_path, monkeypatch, base, traffic, fault):
    name = small_cell(tmp_path, base, "fault." + base, **traffic)
    fault(monkeypatch)
    res = run_small(tmp_path, name)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
