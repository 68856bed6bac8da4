"""Simulation parameters.

The seven-field parameter set of the reference solver (the ``t_param`` struct,
reference SerialCode/d2q9-bgk.c:66-75, loaded by ``initialise``,
SerialCode/d2q9-bgk.c:480-506): grid extents, iteration count, Reynolds
dimension, and the three physics constants (density, accel, omega).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LBMParams:
    """Parameters of one D2Q9-BGK simulation.

    Attributes:
      nx: number of cells in the x-direction.
      ny: number of cells in the y-direction.
      max_iters: number of timesteps.
      reynolds_dim: length scale used for the Reynolds-number report.
      density: density per link used for the equilibrium initial condition.
      accel: density redistribution magnitude of the driven row.
      omega: BGK relaxation parameter.
    """

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    def __post_init__(self) -> None:
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid extents must be positive, got {self.nx}x{self.ny}")
        if self.max_iters < 0:
            raise ValueError(f"max_iters must be >= 0, got {self.max_iters}")

    @property
    def accel_row(self) -> int:
        """Global row index of the driven (accelerated) row.

        The reference accelerates the second row from the top
        (SerialCode/d2q9-bgk.c:223).
        """
        return self.ny - 2

    @property
    def viscosity(self) -> float:
        """Kinematic viscosity implied by omega (SerialCode/d2q9-bgk.c:639)."""
        return (2.0 / self.omega - 1.0) / 6.0

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    def replace(self, **kw) -> "LBMParams":
        return dataclasses.replace(self, **kw)


def with_driven_row(params, row: int):
    """A copy of ``params`` (this package's LBMParams or any dataclass of
    the same fields with an ``accel_row`` property) whose driven row is
    ``row`` instead of ny - 2.  The kernels take the row as an argument, so
    kernel checks put it in any row block, ghost or shard."""
    cls = type(type(params).__name__, (type(params),),
               {"accel_row": property(lambda self: row)})
    return cls(**{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
