"""The control of each cell comes out not correct under the cell's own
limits, where the program comes out correct.

The control is the step to a lower precision that would tempt a change:
for the scene cells the program's own int16 storage; for the ensemble,
which has no such path, the plain reference with its state in bfloat16
(``bf16s``; computed wholly in bfloat16 it blows up, which fails but
gives no reading), put in the program's place.  At the cells' own size on
the card (``-m cuda``), as ``portbench/control.py`` reads it; on the CPU at
a size a test run holds, where the gaps are smaller for fewer steps: there
int16 at omega 1.68 (the first seed) still fails the 1024x1024 cell's
limits, and at omega 1.87 it would not."""

from __future__ import annotations

import pytest

from portbench.tests.helpers import SMALL_SCENE, SMALL_SWEEP, small_cell
from portbench import cells, control, jobs

MODES = {"refbox.1024": ["program", "i16", "bf16s"], "sweep128.omega64": ["program", "bf16s"]}
CPU_SEEDS = {"refbox.1024": (2**31 + 3,), "sweep128.omega64": (2**31 + 3, 41)}
SMALL = {"refbox.1024": {**SMALL_SCENE, "grid": [64, 64], "steps": 1500},
         "sweep128.omega64": {**SMALL_SWEEP, "grid": [48, 48], "steps": 1500}}


def judged(base, readings):
    limits = cells.load_cell(base)[0]["limits"]
    return {mode: all(got[k] <= limits[k] for k in jobs.CHECKS) for mode, got, _ in readings}


@pytest.mark.parametrize("base", sorted(MODES))
def test_control_fails_on_the_cpu(tmp_path, base):
    name = small_cell(tmp_path, base, "control." + base, **SMALL[base])
    for seed in CPU_SEEDS[base]:
        ok = judged(base, control.readings(name, seed, MODES[base], "cpu",
                                           (tmp_path, cells.HERE)))
        assert ok == {mode: mode == "program" for mode in MODES[base]}


@pytest.mark.cuda
@pytest.mark.parametrize("base", sorted(MODES))
def test_control_fails_at_the_cells_size(base):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    for seed in (2**31 + 5, 2**31 + 6, 2**31 + 7):
        ok = judged(base, control.readings(base, seed, MODES[base], "cuda"))
        assert ok == {mode: mode == "program" for mode in MODES[base]}

