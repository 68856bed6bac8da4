"""The scene data: the 1024x1024 obstacle file derived again from golden/."""

from __future__ import annotations

import numpy as np

from portbench.tests.helpers import REPO
from portbench import scene


def test_obstacles_1024_equal_golden_walls(tmp_path):
    walls = scene.golden_walls(REPO / "golden" / "1024x1024.final_state.dat.gz")
    path = tmp_path / "obstacles_1024x1024.dat"
    scene.write_obstacles(path, walls)
    shipped = scene.HERE / "scenes" / "obstacles_1024x1024.dat"
    assert path.read_bytes() == shipped.read_bytes()
    mask = scene.load_obstacles(shipped, 1024, 1024)
    assert mask.sum() == 5114
    expected = scene.box(1024, 1024)
    expected[:, 341] = True
    assert np.array_equal(mask, expected)


def test_config_scenes():
    from portbench import cells

    _, refbox = cells.load_cell("refbox.1024")
    mask, phys = scene.make(refbox, (1024, 1024))
    assert mask.sum() == 5114 and phys == {"density": 0.1, "accel": 0.01, "reynolds_dim": 10}
    mask, phys = scene.make(refbox, (256, 256))
    assert np.array_equal(mask, scene.box(256, 256)) and phys["accel"] == 0.005
