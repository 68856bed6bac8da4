"""Back-to-back runs of one scene: what a user re-running a scene pays for.

The seed draws the run's omega once, uniformly from the traffic's
``omega`` range; every job of the run repeats the same scene, as the
program's ``run`` command would (``python -m lbm_tpu_torch run``, without
the files): ``lbm_tpu_torch.models.driver.run_simulation`` on one card
(``num_devices=1``: ``auto`` would shard over every card of the host),
the policy's variant, the traffic's storage.  A job ends with ``f`` and
``av_vels`` in host memory.
"""

from __future__ import annotations

import numpy as np

from portbench import scene
from portbench.jobs import Inputs, JobOut

ENSEMBLE = False

# The program's single-device variants and the kernel each runs
# (lbm_tpu_torch/models/program.py).
KERNELS = {
    "cuda-step": "K1", "cuda-resident": "K2", "cuda-inplace": "K3", "cuda-trapezoid": "K4",
    "cuda-skew": "K5", "cuda-hbm": "K9", "cuda-blocked": "K10", "cuda-step-i16": "K1-i16",
    "cuda-inplace-i16": "K3-i16", "cuda-trapezoid-i16": "K4-i16", "cuda-skew-i16": "K5-i16",
    "torch": "the plain torch step",
}


def inputs(traffic: dict, config: dict, seed: int) -> Inputs:
    rng = np.random.default_rng(seed)
    omega = np.float32(rng.uniform(*traffic["omega"]))
    mask, phys = scene.make(config, tuple(traffic["grid"]))
    return Inputs(mask, np.array([omega], np.float32), np.array([phys["accel"]], np.float32),
                  phys["density"], phys["reynolds_dim"], traffic["steps"])


def runner(inp: Inputs, device: str, storage: str = "f32"):
    """A function that runs one job of ``inp`` and returns its :class:`JobOut`."""
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.models import driver
    from lbm_tpu_torch.params import LBMParams

    ny, nx = inp.mask.shape
    params = LBMParams(nx=nx, ny=ny, max_iters=inp.steps, reynolds_dim=inp.reynolds_dim,
                       density=inp.density, accel=float(inp.accels[0]),
                       omega=float(inp.omegas[0]))
    the_scene = Scene(params=params, obstacles=inp.mask)
    config = driver.RunConfig(device=device, num_devices=1, variant="auto", storage=storage)

    def job() -> JobOut:
        res = driver.run_simulation(the_scene, config)
        kernel = KERNELS.get(res.variant, "?")
        return JobOut(res.f[None], res.av_vels[:, None], dict(res.timer.elapsed),
                      f"{res.variant} ({kernel})")

    return job
