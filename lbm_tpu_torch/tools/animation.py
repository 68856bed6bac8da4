"""Animation frame files.

Frames are captured on the device during the run (models/driver.py) and
flushed here after it, in the reference's frame-file format
(``animation_data/velocity_magnitude_%06d.dat``: a ``# nx= ny= timestep=``
header, then one %.6E magnitude per line, SerialCode/d2q9-bgk.c:802-849),
byte for byte as ``lbm_tpu/tools/animation.py`` writes them.  GIF rendering
(``animate``) is not ported yet.
"""

from __future__ import annotations

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
