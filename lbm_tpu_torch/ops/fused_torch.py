"""The fused collide-stream timestep in plain PyTorch: the twin of the step.

The torch counterpart of ``lbm_tpu/ops/fused_jnp.py`` (full-grid form):
driven-row injection, pull streaming with periodic wrap on both axes,
bounce-back, BGK collision and the per-step |u| sum, with the cell math of
ops/stencil_math.py.  It runs on any device and is the plain version every
CUDA kernel of this package is held to, bitwise on fields.

``fused_step_i16`` is the same step on int16 storage (ops/quant.py):
dequantize, step in float32, quantize.  That is B1's i16 order, load ->
dequant -> accel -> stream -> collide -> quant
(``lbm_tpu/ops/fused_pallas.py:304-351``), and the plain version of every
i16 kernel here.

``sweep`` / ``run_sweeps`` are K steps taken as one temporal sweep, the
plain version of the sweep kernels (K4, K5): bitwise K twin steps in f32,
and one quantization per sweep in int16.

The slab form (``stream_slab`` / ``fused_step_slab``) belongs to the
sharded modes and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import quant, stencil_math
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


def fused_step_i16(
    q: torch.Tensor, obstacles: torch.Tensor, params: LBMParams
) -> StepOutput:
    """One step on int16 state: ``q`` (9, ny, nx) int16 -> (int16 state,
    tot_u), tot_u taken from the dequantized values."""
    f_new, tot_u = fused_step_single(quant.dequantize(q, params.density), obstacles, params)
    return StepOutput(quant.quantize(f_new, params.density), tot_u)


def run_steps(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    num_steps: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` twin steps: returns (f_final, tot_us (num_steps,)).
    With ``storage="i16"`` the state is int16 in and out.

    The per-step sums are written into one tensor on ``f``'s device, so the
    loop never waits for the device."""
    quant.check_storage(storage)
    step = fused_step_i16 if storage == "i16" else fused_step_single
    tot_us = torch.empty(num_steps, dtype=torch.float32, device=f.device)
    for t in range(num_steps):
        f, tot_us[t] = step(f, obstacles, params)
    return f, tot_us


def sweep(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    K: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One K-step temporal sweep, the plain version of the sweep kernels
    (K4, K5): decode the state once, take K float32 twin steps, encode once;
    returns (state, tot_us (K,)), tot_u taken from the float32 levels.

    For int16 storage that is what ``lbm_tpu``'s sweeps compute: the levels
    stay float32 on chip and the state is quantized once per sweep, with the
    per-plane codec of ``quant.plane_codec``
    (``lbm_tpu/ops/temporal_pallas.py:205``, ``skew_pallas.py:249``).  For
    float32 it is K twin steps."""
    deq, enq = quant.plane_codec(storage, params.density)
    x = torch.stack([deq(f[k], k) for k in range(lattice.NSPEEDS)])
    x, tot_us = run_steps(x, obstacles, params, K)
    return torch.stack([enq(x[k], k) for k in range(lattice.NSPEEDS)]), tot_us


def run_sweeps(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    num_steps: int,
    K: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` steps as whole K-step sweeps, then the remainder as
    single steps (``temporal_pallas.make_run_all`` :673): returns (state,
    tot_us (num_steps,))."""
    n_sweeps, rem = divmod(num_steps, K)
    parts = []
    for _ in range(n_sweeps):
        f, tot = sweep(f, obstacles, params, K, storage)
        parts.append(tot)
    f, tot = run_steps(f, obstacles, params, rem, storage)
    parts.append(tot)
    return f, torch.cat(parts)
