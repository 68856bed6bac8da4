"""Animation frame files and GIFs.

Frames are captured on the device during the run (models/driver.py) and
flushed here after it, in the reference's frame-file format
(``animation_data/velocity_magnitude_%06d.dat``: a ``# nx= ny= timestep=``
header, then one %.6E magnitude per line, SerialCode/d2q9-bgk.c:802-849),
byte for byte as ``lbm_tpu/tools/animation.py`` writes them.
:func:`animate_directory` (``animate``, needs matplotlib) builds a GIF of a
frame directory, the reference's Visualization/animation.py.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from lbm_tpu_torch.params import LBMParams


def write_frame_files(
    out_dir: str,
    frames: np.ndarray,
    frame_steps: np.ndarray,
    params: LBMParams,
) -> list[str]:
    """Flush captured |u| frames to per-timestep .dat files."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for frame, tt in zip(frames, frame_steps):
        path = os.path.join(out_dir, f"velocity_magnitude_{int(tt):06d}.dat")
        with open(path, "w") as fp:
            fp.write(f"# nx={params.nx} ny={params.ny} timestep={int(tt)}\n")
            fp.writelines("%.6E\n" % v for v in frame.ravel())
        paths.append(path)
    return paths


def read_frame_file(path: str) -> tuple[np.ndarray, dict]:
    """(frame, header fields) of one frame file; the frame is (ny, nx)
    where the header gives both."""
    with open(path) as fp:
        header = fp.readline()
        meta = dict(re.findall(r"(\w+)=(\d+)", header))
        vals = np.loadtxt(fp, dtype=np.float32)
    nx, ny = int(meta.get("nx", 0)), int(meta.get("ny", 0))
    if nx and ny:
        vals = vals.reshape(ny, nx)
    return vals, {k: int(v) for k, v in meta.items()}


def animate_directory(frames_dir: str, output: str, fps: int = 10, every: int = 1) -> str:
    """Build a GIF from a directory of frame files (``lbm_tpu``'s
    animation.py :53).  ``every`` keeps every N-th frame, the reference's
    quick preview (Visualization/animation.py:146-198 keeps every 20th)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    paths = sorted(glob.glob(os.path.join(frames_dir, "velocity_magnitude_*.dat")))
    if not paths:
        raise FileNotFoundError(f"no velocity_magnitude_*.dat frames in {frames_dir}")
    frames = [read_frame_file(p)[0] for p in paths[:: max(1, every)]]
    vmax = max(float(f.max()) for f in frames) or 1.0

    fig, ax = plt.subplots(figsize=(6, 6 * frames[0].shape[0] / frames[0].shape[1]))
    im = ax.imshow(frames[0], origin="lower", cmap="viridis", vmin=0.0, vmax=vmax)
    fig.colorbar(im, ax=ax, label="|u|")
    ax.set_title("velocity magnitude")

    def update(i):
        im.set_data(frames[i])
        return (im,)

    anim = manim.FuncAnimation(fig, update, frames=len(frames), blit=True)
    anim.save(output, writer=manim.PillowWriter(fps=fps))
    plt.close(fig)
    return output
