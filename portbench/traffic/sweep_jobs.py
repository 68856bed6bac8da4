"""Back-to-back parameter studies of one scene: what ``sweep`` exists for.

The seed draws the study's B omegas once, uniformly from the traffic's
``omega`` range (the form of ``lbm_tpu``'s README sweep,
``--omega 1.3:1.9:8``); every job of the run repeats the same study, as the
program's ``sweep`` command would, without the plot:
``lbm_tpu_torch.tools.ensemble.run_ensemble``, the ensemble policy's
kernel, float32.  A job ends with every instance's ``f`` and ``av_vels``
in host memory.
"""

from __future__ import annotations

import numpy as np

from portbench import scene
from portbench.jobs import Inputs, JobOut

ENSEMBLE = True


def inputs(traffic: dict, config: dict, seed: int) -> Inputs:
    rng = np.random.default_rng(seed)
    omegas = rng.uniform(*traffic["omega"], size=traffic["instances"]).astype(np.float32)
    mask, phys = scene.make(config, tuple(traffic["grid"]))
    return Inputs(mask, omegas, np.full(omegas.size, phys["accel"], np.float32),
                  phys["density"], phys["reynolds_dim"], traffic["steps"])


def runner(inp: Inputs, device: str, storage: str = "f32"):
    """A function that runs one study of ``inp`` and returns its :class:`JobOut`."""
    if storage != "f32":
        raise ValueError("the ensemble runs float32 only")
    from lbm_tpu_torch.params import LBMParams
    from lbm_tpu_torch.tools import ensemble

    ny, nx = inp.mask.shape
    params = LBMParams(nx=nx, ny=ny, max_iters=inp.steps, reynolds_dim=inp.reynolds_dim,
                       density=inp.density, accel=float(inp.accels[0]),
                       omega=float(inp.omegas[0]))

    def job() -> JobOut:
        res = ensemble.run_ensemble(params, inp.mask, inp.omegas, inp.accels, inp.steps, device)
        return JobOut(res.f, res.av_vels, None, res.kernel)

    return job
