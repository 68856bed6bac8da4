"""Shared per-cell D2Q9-BGK math on tensors.

The torch counterpart of ``lbm_tpu/ops/stencil_math.py``, op for op and in
the same association order, so that the plain step (ops/fused_torch.py) and
the CUDA kernels (csrc/lbm_common.cuh follows this file line by line) give
bitwise-identical fields on the card:

- **paired equilibria**: opposite directions share their quadratic term,
  ``d_equ(+-u) = A +- Bu`` with ``A = w*rho*(1 + 4.5u^2 - 1.5|u|^2)`` and
  ``Bu = w*rho*3u``;
- **moment-reused av_velocity**: |u| for the per-step reduction comes from
  the pre-collision moments (BGK conserves density and momentum per cell).

Every op is a single IEEE float32 operation (``+ - * /``, ``sqrt``,
``where``); nothing here may be fused or contracted, so keep it out of
``torch.compile``.  Constants are float32 values passed as Python floats,
which torch converts to float32 exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.core import lattice

NS = lattice.NSPEEDS

# float32 constants, rounded exactly as ``np.float32(...)`` in lbm_tpu.
_W0 = float(np.float32(4.0 / 9.0))
_W1 = float(np.float32(1.0 / 9.0))
_W2 = float(np.float32(1.0 / 36.0))


def accel_planes(planes, fluid, row_mask, w1: float, w2: float):
    """Driven-row injection on 9 (R, nx) planes.

    ``row_mask`` (R, 1) selects rows whose global index is the driven row;
    the guard requires a fluid cell whose three decremented west-side speeds
    stay positive (SerialCode/d2q9-bgk.c:216-246).
    """
    ok = (
        row_mask
        & fluid
        & (planes[3] - w1 > 0.0)
        & (planes[6] - w2 > 0.0)
        & (planes[7] - w2 > 0.0)
    )
    okf = ok.to(torch.float32)
    d1 = okf * w1
    d2 = okf * w2
    return [
        planes[0],
        planes[1] + d1,
        planes[2],
        planes[3] - d1,
        planes[4],
        planes[5] + d2,
        planes[6] - d2,
        planes[7] - d2,
        planes[8] + d2,
    ]


def moments(t):
    """Per-cell density and velocity from 9 distribution planes
    (SerialCode/d2q9-bgk.c:324-347)."""
    rho = ((((((((t[0] + t[1]) + t[2]) + t[3]) + t[4]) + t[5]) + t[6]) + t[7]) + t[8])
    u_x = ((t[1] + t[5] + t[8]) - (t[3] + t[6] + t[7])) / rho
    u_y = ((t[2] + t[5] + t[6]) - (t[4] + t[7] + t[8])) / rho
    return rho, u_x, u_y


def collide(t, obst, omega: float, rho, u_x, u_y, u_sq):
    """Bounce-back + paired-equilibrium BGK relaxation.

    Obstacle cells receive mirrored streamed values (rebound,
    SerialCode/d2q9-bgk.c:279-304), fluid cells relax toward equilibrium
    (collision, SerialCode/d2q9-bgk.c:306-407).
    """
    usq_term = u_sq * 1.5
    w0rho = rho * _W0
    w1rho = rho * _W1
    w2rho = rho * _W2
    base = 1.0 - usq_term

    d_equ = [None] * NS
    d_equ[0] = w0rho * base
    for kp, km, u, wrho in (
        (1, 3, u_x, w1rho),
        (2, 4, u_y, w1rho),
        (5, 7, u_x + u_y, w2rho),
        (6, 8, u_y - u_x, w2rho),
    ):
        a = wrho * (base + (u * u) * 4.5)
        b = wrho * (u * 3.0)
        d_equ[kp] = a + b
        d_equ[km] = a - b

    out = []
    for k in range(NS):
        relaxed = t[k] + (d_equ[k] - t[k]) * omega
        out.append(torch.where(obst, t[lattice.OPP[k]], relaxed))
    return out


def speeds(u_sq, fluid):
    """Per-cell |u| = sqrt(u_sq) on fluid cells, 0 on obstacles."""
    return torch.where(fluid, torch.sqrt(u_sq), torch.zeros_like(u_sq))


def collide_and_av(streamed, obst, omega: float):
    """Full post-stream cell update: returns (9 planes, tot_u scalar)."""
    rho, u_x, u_y = moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = collide(streamed, obst, omega, rho, u_x, u_y, u_sq)
    return out, torch.sum(speeds(u_sq, ~obst), dtype=torch.float32)


def collide_and_av_rows(streamed, obst, omega: float, row_mask=None):
    """:func:`collide_and_av` with the |u| partial reduced over rows only
    (``lbm_tpu``'s ``collide_and_av_rows``): returns (9 planes, (1, nx)
    per-column partial).  ``row_mask`` (rows, 1) bool, optional, leaves rows
    out of the partial; fields are unaffected.

    The rows are added one after another in row order, so a caller that
    walks a step as row blocks gets a fixed grouping of the step's |u| sum,
    the one K10 (csrc/blocked.cu) takes: the rows of a block in row order,
    then the blocks' partials in block order, then one sum over the columns
    in the fixed order of ``fused_torch.column_sum``.  It is ``lbm_tpu``'s
    av-partial contract (``av_mode`` there; its layouts are not ported, K2
    has one): the same values as :func:`collide_and_av` up to the order of
    the float32 additions."""
    rho, u_x, u_y = moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = collide(streamed, obst, omega, rho, u_x, u_y, u_sq)
    fluid = ~obst
    if row_mask is not None:
        fluid = fluid & row_mask
    s = speeds(u_sq, fluid)
    vec = s[0:1]
    for r in range(1, s.shape[0]):
        vec = vec + s[r:r + 1]
    return out, vec
