"""The plain reference against the program's plain torch step on the CPU,
and its independence from the program."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.tests.helpers import REPO
from portbench import jobs, scene
from portbench.reference import lbm


@pytest.mark.parametrize("grid,steps", [((24, 32), 150), ((33, 20), 90)])
def test_single_agrees_with_fused_torch(grid, steps):
    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_torch
    from lbm_tpu_torch.params import LBMParams

    ny, nx = grid
    mask = scene.box(ny, nx)
    mask[ny // 2, nx // 3: nx // 2] = True
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.7)
    f0 = torch.from_numpy(lattice.equilibrium_rest(0.1, ny, nx))
    f, tots = fused_torch.run_steps(f0, torch.from_numpy(mask), params, steps)
    ref_f, ref_av = lbm.run(torch.from_numpy(mask), [1.7], [0.005], 0.1, steps)
    np.testing.assert_allclose(ref_f[0].numpy(), f.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ref_av[:, 0].numpy(), tots.numpy() / (~mask).sum(), rtol=1e-4)


def test_batch_agrees_with_ensemble_plain():
    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_torch

    ny, nx, B, steps = 20, 28, 4, 120
    mask = scene.box(ny, nx)
    omegas = np.linspace(1.3, 1.9, B).astype(np.float32)
    w1, w2 = fused_torch.ensemble_weights(0.1, np.full(B, 0.005, np.float32))
    f0 = torch.from_numpy(lattice.equilibrium_rest(0.1, ny, nx)).expand(B, -1, -1, -1)
    f, tot = fused_torch.run_ensemble_plain(f0.contiguous(), torch.from_numpy(mask),
                                            torch.from_numpy(omegas), torch.from_numpy(w1),
                                            torch.from_numpy(w2), ny - 2, steps)
    ref_f, ref_av = lbm.run(torch.from_numpy(mask), omegas, np.full(B, 0.005), 0.1, steps)
    np.testing.assert_allclose(ref_f.numpy(), f.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ref_av.numpy(), tot.numpy() / (~mask).sum(), rtol=1e-4)


def test_gaps_of_the_reference_against_itself_and_a_changed_copy():
    inp = jobs.Inputs(scene.box(16, 16), np.array([1.5, 1.8], np.float32),
                      np.array([0.005, 0.005], np.float32), 0.1, 10, 40)
    f, av = jobs.reference(inp, "cpu")
    assert jobs.gaps(jobs.JobOut(f, av, None, ""), f, av) == {"f_gap": 0.0, "av_gap": 0.0}
    g = f.copy()
    g[1, 2, 5, 5] *= 1.01
    got = jobs.gaps(jobs.JobOut(g, av, None, ""), f, av)
    assert got["f_gap"] > 1e-4 and got["av_gap"] == 0.0
    g[0, 0, 0, 0] = np.nan
    assert jobs.gaps(jobs.JobOut(g, av, None, ""), f, av)["f_gap"] == float("inf")


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.reference.lbm, "
            "portbench.jobs; print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lbm_tpu_torch', 'lbm_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
