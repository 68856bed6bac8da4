"""Scene input: parameter files and obstacle masks.

File formats follow the reference exactly:

- ``input_*.params``: seven whitespace-separated values in order
  ``nx ny maxIters reynolds_dim density accel omega``
  (SerialCode/d2q9-bgk.c:480-506).
- ``obstacles_*.dat``: lines of ``x y 1`` marking blocked cells, with the same
  validation the reference applies — three values per line, coordinates in
  range, blocked flag equal to 1 (SerialCode/d2q9-bgk.c:588-601).

A native C++ fast path (lbm_tpu_torch.io.native) is used for large obstacle files
when the shared library is available; the pure-Python path is the fallback and
the semantics oracle.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from lbm_tpu_torch.params import LBMParams


class SceneError(ValueError):
    """Raised on malformed scene input (the reference calls die(),
    SerialCode/d2q9-bgk.c:745-751)."""


def load_params(path: str | os.PathLike) -> LBMParams:
    with open(path, "r") as fp:
        tokens = fp.read().split()
    if len(tokens) < 7:
        raise SceneError(f"param file {path!r} has {len(tokens)} fields, expected 7")
    try:
        return LBMParams(
            nx=int(tokens[0]),
            ny=int(tokens[1]),
            max_iters=int(tokens[2]),
            reynolds_dim=int(tokens[3]),
            density=float(tokens[4]),
            accel=float(tokens[5]),
            omega=float(tokens[6]),
        )
    except ValueError as e:
        raise SceneError(f"could not parse param file {path!r}: {e}") from e


def load_obstacles(path: str | os.PathLike, nx: int, ny: int) -> np.ndarray:
    """Parse an obstacle file into a boolean mask of shape ``(ny, nx)``."""
    try:
        from lbm_tpu_torch.io import native

        mask = native.load_obstacles(os.fspath(path), nx, ny)
        if mask is not None:
            return mask
    except ImportError:
        pass
    return _load_obstacles_py(path, nx, ny)


def _load_obstacles_py(path: str | os.PathLike, nx: int, ny: int) -> np.ndarray:
    mask = np.zeros((ny, nx), dtype=bool)
    with open(path, "r") as fp:
        for lineno, line in enumerate(fp, 1):
            fields = line.split()
            if not fields:
                continue
            if len(fields) != 3:
                raise SceneError(
                    f"{path}:{lineno}: expected 3 values per line, got {len(fields)}"
                )
            xx, yy, blocked = (int(v) for v in fields)
            if not 0 <= xx < nx:
                raise SceneError(f"{path}:{lineno}: obstacle x-coord out of range")
            if not 0 <= yy < ny:
                raise SceneError(f"{path}:{lineno}: obstacle y-coord out of range")
            if blocked != 1:
                raise SceneError(f"{path}:{lineno}: obstacle blocked value should be 1")
            mask[yy, xx] = True
    return mask


@dataclasses.dataclass(frozen=True)
class Scene:
    """A fully loaded simulation scene."""

    params: LBMParams
    obstacles: np.ndarray  # bool, (ny, nx)

    @property
    def num_fluid_cells(self) -> int:
        """Global fluid-cell count; the divisor of the av_vels series
        (MPI/d2q9-bgk.c:774-784)."""
        return int(self.obstacles.size - np.count_nonzero(self.obstacles))


def load_scene(paramfile: str | os.PathLike, obstaclefile: str | os.PathLike) -> Scene:
    params = load_params(paramfile)
    obstacles = load_obstacles(obstaclefile, params.nx, params.ny)
    return Scene(params=params, obstacles=obstacles)
