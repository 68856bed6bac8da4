"""Output writers in the reference's exact text formats.

- ``final_state.dat``: one line per cell, row-major, ``ii jj u_x u_y |u|
  pressure obstacle`` with %.12E floats; obstacle cells get zero velocity and
  pressure ``density/3`` (SerialCode/d2q9-bgk.c:662-726).
- ``av_vels.dat``: one line per step, ``tt:\\t%.12E``
  (SerialCode/d2q9-bgk.c:735-738).

A native C++ formatter (lbm_tpu_torch.io.native) accelerates the million-line
final_state dump for large grids; NumPy/Python is the fallback.
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu_torch.core import oracle
from lbm_tpu_torch.params import LBMParams

C_SQ = 1.0 / 3.0


def macroscopics(
    f: np.ndarray, obstacles: np.ndarray, params: LBMParams
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell (u_x, u_y, |u|, pressure) with the reference's obstacle
    convention: zero velocity and pressure = density * c_sq on blocked cells
    (SerialCode/d2q9-bgk.c:683-719)."""
    f = np.asarray(f, dtype=np.float32)
    rho = oracle.local_density(f)
    u_x = ((f[1] + f[5] + f[8]) - (f[3] + f[6] + f[7])) / rho
    u_y = ((f[2] + f[5] + f[6]) - (f[4] + f[7] + f[8])) / rho
    u = np.sqrt(u_x * u_x + u_y * u_y, dtype=np.float32)
    pressure = rho * np.float32(C_SQ)
    zero = np.float32(0.0)
    u_x = np.where(obstacles, zero, u_x)
    u_y = np.where(obstacles, zero, u_y)
    u = np.where(obstacles, zero, u)
    pressure = np.where(obstacles, np.float32(params.density) * np.float32(C_SQ), pressure)
    return u_x, u_y, u, pressure


def write_final_state(
    path: str | os.PathLike,
    f: np.ndarray,
    obstacles: np.ndarray,
    params: LBMParams,
) -> None:
    u_x, u_y, u, pressure = macroscopics(f, obstacles, params)
    try:
        from lbm_tpu_torch.io import native

        if native.write_final_state(os.fspath(path), u_x, u_y, u, pressure, obstacles):
            return
    except ImportError:
        pass
    _write_final_state_py(path, u_x, u_y, u, pressure, obstacles, params)


def _write_final_state_py(path, u_x, u_y, u, pressure, obstacles, params) -> None:
    ny, nx = obstacles.shape
    obst_int = obstacles.astype(np.int32)
    with open(path, "w") as fp:
        for jj in range(ny):
            ux_r, uy_r, u_r, p_r, o_r = u_x[jj], u_y[jj], u[jj], pressure[jj], obst_int[jj]
            fp.writelines(
                "%d %d %.12E %.12E %.12E %.12E %d\n"
                % (ii, jj, ux_r[ii], uy_r[ii], u_r[ii], p_r[ii], o_r[ii])
                for ii in range(nx)
            )


def write_av_vels(path: str | os.PathLike, av_vels: np.ndarray) -> None:
    av_vels = np.asarray(av_vels)
    try:
        from lbm_tpu_torch.io import native

        if native.write_av_vels(os.fspath(path), av_vels):
            return
    except ImportError:
        pass
    with open(path, "w") as fp:
        fp.writelines(
            "%d:\t%.12E\n" % (tt, av_vels[tt]) for tt in range(av_vels.shape[0])
        )


def read_av_vels(path: str | os.PathLike) -> np.ndarray:
    """Load the value column of an av_vels.dat file (check/check.py:57-60)."""
    return np.loadtxt(path, usecols=[1], dtype=np.float64, ndmin=1)


def read_final_state(path: str | os.PathLike) -> np.ndarray:
    """Load the columns the validation contract compares: (x, y, pressure).

    Column 5 of a final_state line is the *pressure*; the reference checker
    loads exactly usecols=[0, 1, 5] (check/check.py:61-63), so the golden
    comparison validates the pressure field, not |u| (column 4).
    """
    return np.loadtxt(path, usecols=[0, 1, 5], dtype=np.float64, ndmin=2)
