"""NumPy serial oracle: the ground-truth D2Q9-BGK solver.

Reimplements, pass by pass, the serial reference algorithm
(SerialCode/d2q9-bgk.c:207-458) in vectorized float32 NumPy: accelerate_flow,
propagate (pull streaming with fully periodic wrap), rebound (bounce-back on
obstacle cells), BGK collision on fluid cells, and the per-step av_velocity
reduction over post-collision state.  Used to regenerate golden data, to
cross-check the fused JAX/Pallas paths at small step counts, and as the
"serial" solver variant of the CLI.

Arithmetic is ordered to mirror the C expressions (same association order) so
float32 results track the reference closely; residual drift is covered by the
1% validation tolerance of the output contract (check/check.py:19-24).
"""

from __future__ import annotations

import numpy as np

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.params import LBMParams

F32 = np.float32


def accelerate_flow(f: np.ndarray, obstacles: np.ndarray, params: LBMParams) -> None:
    """In-place driven-row injection (SerialCode/d2q9-bgk.c:216-246).

    Only row ``ny-2``; only fluid cells whose three decremented west-side
    speeds (3, 6, 7) all stay strictly positive after the update.
    """
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    jj = params.ny - 2
    row = f[:, jj, :]  # (9, nx) view
    ok = (
        (~obstacles[jj, :])
        & (row[3] - w1 > F32(0.0))
        & (row[6] - w2 > F32(0.0))
        & (row[7] - w2 > F32(0.0))
    )
    row[1] = np.where(ok, row[1] + w1, row[1])
    row[5] = np.where(ok, row[5] + w2, row[5])
    row[8] = np.where(ok, row[8] + w2, row[8])
    row[3] = np.where(ok, row[3] - w1, row[3])
    row[6] = np.where(ok, row[6] - w2, row[6])
    row[7] = np.where(ok, row[7] - w2, row[7])


def propagate(f: np.ndarray) -> np.ndarray:
    """Pull-form streaming with periodic wrap on both axes
    (SerialCode/d2q9-bgk.c:248-277).

    ``tmp[k][j, i] = f[k][j - cy_k, i - cx_k]`` which is
    ``np.roll(f[k], (cy_k, cx_k))``.
    """
    tmp = np.empty_like(f)
    for k in range(lattice.NSPEEDS):
        tmp[k] = np.roll(f[k], (lattice.CY[k], lattice.CX[k]), axis=(0, 1))
    return tmp


def rebound(f: np.ndarray, tmp: np.ndarray, obstacles: np.ndarray) -> None:
    """Bounce-back on obstacle cells, written back into ``f``
    (SerialCode/d2q9-bgk.c:279-304).  Speed 0 is left untouched.
    """
    for k in range(1, lattice.NSPEEDS):
        f[k] = np.where(obstacles, tmp[lattice.OPP[k]], f[k])


def collision(f: np.ndarray, tmp: np.ndarray, obstacles: np.ndarray, params: LBMParams) -> None:
    """BGK relaxation toward the 2nd-order equilibrium on fluid cells,
    written back into ``f`` (SerialCode/d2q9-bgk.c:306-407).
    """
    omega = F32(params.omega)
    c_sq = F32(1.0) / F32(3.0)
    two_csq = F32(2.0) * c_sq
    two_csq_sq = two_csq * c_sq
    w0 = F32(4.0) / F32(9.0)
    w1 = F32(1.0) / F32(9.0)
    w2 = F32(1.0) / F32(36.0)

    rho = local_density(tmp)
    u_x = ((tmp[1] + tmp[5] + tmp[8]) - (tmp[3] + tmp[6] + tmp[7])) / rho
    u_y = ((tmp[2] + tmp[5] + tmp[6]) - (tmp[4] + tmp[7] + tmp[8])) / rho
    u_sq = u_x * u_x + u_y * u_y

    u_dir = (
        None,
        u_x,
        u_y,
        -u_x,
        -u_y,
        u_x + u_y,
        u_y - u_x,
        -u_x - u_y,
        u_x - u_y,
    )
    usq_term = u_sq / two_csq

    fluid = ~obstacles
    d_equ0 = w0 * rho * (F32(1.0) - usq_term)
    f[0] = np.where(fluid, tmp[0] + omega * (d_equ0 - tmp[0]), f[0])
    for k in range(1, lattice.NSPEEDS):
        w = w1 if k < 5 else w2
        u = u_dir[k]
        d_equ = w * rho * (F32(1.0) + u / c_sq + (u * u) / two_csq_sq - usq_term)
        f[k] = np.where(fluid, tmp[k] + omega * (d_equ - tmp[k]), f[k])


def local_density(f: np.ndarray) -> np.ndarray:
    """Per-cell density: left-associated sum over the 9 speeds, matching the
    sequential accumulation of the reference (SerialCode/d2q9-bgk.c:327-330)."""
    rho = f[0].astype(F32).copy()
    for k in range(1, lattice.NSPEEDS):
        rho = rho + f[k]
    return rho


def velocity(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell (u_x, u_y) macroscopic velocity (SerialCode/d2q9-bgk.c:333-347)."""
    rho = local_density(f)
    u_x = ((f[1] + f[5] + f[8]) - (f[3] + f[6] + f[7])) / rho
    u_y = ((f[2] + f[5] + f[6]) - (f[4] + f[7] + f[8])) / rho
    return u_x, u_y


def av_velocity(f: np.ndarray, obstacles: np.ndarray) -> np.float32:
    """Mean |u| over fluid cells (SerialCode/d2q9-bgk.c:409-458)."""
    u_x, u_y = velocity(f)
    speed = np.sqrt(u_x * u_x + u_y * u_y, dtype=F32)
    fluid = ~obstacles
    tot_u = np.sum(speed, where=fluid, dtype=F32)
    return F32(tot_u / F32(np.count_nonzero(fluid)))


def timestep(f: np.ndarray, obstacles: np.ndarray, params: LBMParams) -> np.ndarray:
    """One full step, mutating and returning ``f``
    (SerialCode/d2q9-bgk.c:207-214)."""
    accelerate_flow(f, obstacles, params)
    tmp = propagate(f)
    rebound(f, tmp, obstacles)
    collision(f, tmp, obstacles, params)
    return f


def run(
    params: LBMParams,
    obstacles: np.ndarray,
    f: np.ndarray | None = None,
    num_steps: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run the serial solver; returns ``(f, av_vels)``.

    Mirrors the reference main loop (SerialCode/d2q9-bgk.c:166-180): per step,
    timestep then av_velocity on the post-collision state.
    """
    if f is None:
        f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    else:
        f = np.array(f, dtype=F32, copy=True)
    steps = params.max_iters if num_steps is None else num_steps
    av_vels = np.empty(steps, dtype=F32)
    for tt in range(steps):
        f = timestep(f, obstacles, params)
        av_vels[tt] = av_velocity(f, obstacles)
    return f, av_vels


def total_density(f: np.ndarray) -> float:
    """Conservation-check helper (SerialCode/d2q9-bgk.c:644-660)."""
    return float(np.sum(f, dtype=np.float64))


def calc_reynolds(params: LBMParams, f: np.ndarray, obstacles: np.ndarray) -> float:
    """Reynolds number from the final av_velocity (SerialCode/d2q9-bgk.c:637-642)."""
    return float(av_velocity(f, obstacles)) * params.reynolds_dim / params.viscosity
