"""The fused collide-stream timestep in plain PyTorch: the twin of the step.

The torch counterpart of ``lbm_tpu/ops/fused_jnp.py`` (full-grid form):
driven-row injection, pull streaming with periodic wrap on both axes,
bounce-back, BGK collision and the per-step |u| sum, with the cell math of
ops/stencil_math.py.  It runs on any device and is the plain version every
CUDA kernel of this package is held to, bitwise on fields.

The slab form (``stream_slab`` / ``fused_step_slab``) belongs to the
sharded modes and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import stencil_math
from lbm_tpu_torch.params import LBMParams


class StepOutput(NamedTuple):
    f: torch.Tensor  # (9, ny, nx) post-collision distributions
    tot_u: torch.Tensor  # scalar: sum over fluid cells of |u| (pre-division)


def step_constants(params: LBMParams) -> tuple[float, float, float]:
    """(omega, w1, w2) as float32 values, the constants every step takes."""
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    return float(np.float32(params.omega)), float(w1), float(w2)


def apply_accel_row(row: torch.Tensor, fluid_row: torch.Tensor, w1: float, w2: float):
    """Driven-row injection on a (9, nx) row (SerialCode/d2q9-bgk.c:216-246).

    Guard: fluid cell AND all three decremented west-side speeds stay
    strictly positive.  Returns a new (9, nx) row.
    """
    planes = stencil_math.accel_planes(list(row), fluid_row, True, w1, w2)
    return torch.stack(planes)


def stream_periodic(f: torch.Tensor) -> torch.Tensor:
    """Full-grid pull streaming with periodic wrap on both axes
    (SerialCode/d2q9-bgk.c:248-277): ``tmp[k][j,i] = f[k][j-cy, i-cx]``."""
    return torch.stack(
        [
            torch.roll(f[k], shifts=(lattice.CY[k], lattice.CX[k]), dims=(0, 1))
            for k in range(lattice.NSPEEDS)
        ]
    )


def fused_step_single(
    f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams
) -> StepOutput:
    """One full timestep on one device (periodic full grid).

    ``f`` (9, ny, nx) float32 and ``obstacles`` (ny, nx) bool on the same
    device.  ``f`` is not modified.
    """
    omega, w1, w2 = step_constants(params)
    jj = params.accel_row
    f = f.clone()
    f[:, jj, :] = apply_accel_row(f[:, jj, :], ~obstacles[jj, :], w1, w2)
    streamed = stream_periodic(f)
    out_planes, tot_u = stencil_math.collide_and_av(list(streamed), obstacles, omega)
    return StepOutput(torch.stack(out_planes), tot_u)


def run_steps(
    f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` twin steps: returns (f_final, tot_us (num_steps,)).

    The per-step sums are written into one tensor on ``f``'s device, so the
    loop never waits for the device."""
    tot_us = torch.empty(num_steps, dtype=torch.float32, device=f.device)
    for t in range(num_steps):
        f, tot_us[t] = fused_step_single(f, obstacles, params)
    return f, tot_us
