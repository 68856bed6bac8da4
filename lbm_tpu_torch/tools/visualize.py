"""Final-state visualization: the 4-panel plots (``viz``).

The counterpart of ``lbm_tpu/tools/visualize.py`` (the reference's
Visualization/visualize_4plots.py): reads a ``final_state.dat``, reshapes it
to 2-D, and renders velocity magnitude, pressure, u_x and u_y with the
obstacles outlined.  Needs matplotlib.
"""

from __future__ import annotations

import numpy as np


def load_final_state(path: str) -> dict[str, np.ndarray]:
    """A final_state.dat as 2-D (ny, nx) fields keyed by name."""
    data = np.loadtxt(path, ndmin=2)
    ii = data[:, 0].astype(int)
    jj = data[:, 1].astype(int)
    nx, ny = ii.max() + 1, jj.max() + 1
    fields = {}
    for name, col in (("u_x", 2), ("u_y", 3), ("u", 4), ("pressure", 5), ("obstacle", 6)):
        grid = np.zeros((ny, nx), dtype=np.float64)
        grid[jj, ii] = data[:, col]
        fields[name] = grid
    return fields


def render_final_state(path: str, output: str, obstacle_outline: bool = True) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fields = load_final_state(path)
    obst = fields["obstacle"] > 0.5

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    panels = [
        ("u", "velocity magnitude |u|", "viridis"),
        ("pressure", "pressure", "coolwarm"),
        ("u_x", "u_x", "RdBu_r"),
        ("u_y", "u_y", "RdBu_r"),
    ]
    for ax, (key, title, cmap) in zip(axes.ravel(), panels):
        field = np.ma.masked_where(obst, fields[key])
        im = ax.imshow(field, origin="lower", cmap=cmap)
        if obstacle_outline and obst.any() and not obst.all():
            ax.contour(obst.astype(float), levels=[0.5], colors="k", linewidths=0.7)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.tight_layout()
    fig.savefig(output, dpi=130)
    plt.close(fig)
    return output
