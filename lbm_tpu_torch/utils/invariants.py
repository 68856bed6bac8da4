"""Physical invariants used as inline sanity checks.

The reference exposes total_density (mass conservation,
SerialCode/d2q9-bgk.c:644-660) and calc_reynolds
(SerialCode/d2q9-bgk.c:637-642).  Note the driven-row injection is exactly
mass-neutral (it adds w1+2*w2 eastward and removes the same westward,
SerialCode/d2q9-bgk.c:234-241), so total density is conserved across steps up
to float rounding.
"""

from __future__ import annotations

from lbm_tpu_torch.params import LBMParams


def calc_reynolds(params: LBMParams, final_av_velocity: float) -> float:
    """Reynolds number from a mean velocity: ``u * reynolds_dim / nu``."""
    return float(final_av_velocity) * params.reynolds_dim / params.viscosity
