"""Carrying simulation state across from ``lbm_tpu``.

``lbm_tpu`` keeps the distributions as a ``(9, ny, nx)`` float32 array and
the obstacles as a ``(ny, nx)`` bool mask; its checkpoints are ``.npz``
files with keys ``f``, ``step`` and ``av_vels``
(lbm_tpu/models/driver.py:748-754).  These helpers take either as numpy and
hand it to this package, which continues the run with
``run_simulation(scene, config, f0=...)``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ReferenceCheckpoint:
    f: np.ndarray  # (9, ny, nx) float32
    step: int  # steps completed
    av_vels: np.ndarray  # (step,) float32


def from_reference(
    f: np.ndarray, obstacles: np.ndarray, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """``lbm_tpu`` state as numpy -> (f float32, obstacles bool) tensors on
    ``device``, contiguous, values unchanged."""
    f = np.asarray(f)
    obstacles = np.asarray(obstacles)
    if obstacles.ndim != 2 or f.shape != (9, *obstacles.shape):
        raise ValueError(
            f"state {f.shape} and obstacle mask {obstacles.shape} are not "
            "(9, ny, nx) and (ny, nx)"
        )
    if f.dtype != np.float32:
        raise ValueError(f"state must be float32, got {f.dtype}")
    f_t = torch.from_numpy(np.ascontiguousarray(f)).to(device)
    o_t = torch.from_numpy(np.ascontiguousarray(obstacles, dtype=bool)).to(device)
    return f_t, o_t


def load_reference_checkpoint(path: str | os.PathLike) -> ReferenceCheckpoint:
    """Read a checkpoint written by ``lbm_tpu run --checkpoint-every``."""
    with np.load(path) as ck:
        return ReferenceCheckpoint(
            f=np.asarray(ck["f"], dtype=np.float32),
            step=int(ck["step"]),
            av_vels=np.asarray(ck["av_vels"], dtype=np.float32),
        )
