"""The scenes of the benchmark's configurations, made without the program.

``box`` is a copy of ``lbm_tpu_torch/tools/bench.make_scene``'s mask: the
upstream's closed box, every border cell a wall.  ``load_obstacles`` reads
an upstream obstacle file (lines of ``x y 1``) into the same (ny, nx) mask.
``golden_walls`` recovers the 1024x1024 scene's wall cells from the wall
flag (the seventh column) of the repository's regenerated final state
(``golden/1024x1024.final_state.dat.gz``), as ``scenes/obstacles_1024x1024.dat``
was made.
"""

from __future__ import annotations

import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def box(ny: int, nx: int) -> np.ndarray:
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return mask


def load_obstacles(path, ny: int, nx: int) -> np.ndarray:
    cells = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if cells.shape[1] != 3 or not (cells[:, 2] == 1).all():
        raise ValueError(f"{path}: expected lines of 'x y 1'")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[cells[:, 1], cells[:, 0]] = True
    return mask


def golden_walls(path) -> np.ndarray:
    """(x, y) of every wall cell of a final_state file, in file order."""
    cells = np.loadtxt(path, usecols=[0, 1, 6], dtype=np.int64)
    return cells[cells[:, 2] != 0][:, :2]


def write_obstacles(path, walls: np.ndarray) -> None:
    with open(path, "w") as fp:
        fp.writelines(f"{x} {y} 1\n" for x, y in walls)


def make(config: dict, grid: tuple[int, int]) -> tuple[np.ndarray, dict]:
    """(wall mask, physics) of ``config`` at ``grid`` = (nx, ny): the
    obstacle file the configuration names for the grid, else the closed box;
    accel by the configuration's rule on the larger extent."""
    nx, ny = grid
    files = config.get("obstacles", {})
    name = f"{nx}x{ny}"
    mask = (load_obstacles(HERE / files[name], ny, nx) if name in files else box(ny, nx))
    phys = config["physics"]
    accel = phys["accel_from_1024"] if max(nx, ny) >= 1024 else phys["accel_below_1024"]
    return mask, {"density": phys["density"], "accel": accel,
                  "reynolds_dim": phys["reynolds_dim"]}
